"""Production-loop soak: a long ``cli.train`` with a mid-run kill and resume,
and a drift and leak report.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.soak --workdir DIR [--steps 20000] [--batch 4]
        [--kill-frac 0.45] [--device cpu] [--times 1700] [--nlat 32 --nlon 64]
        [--override key=value ...]
    python3 -m paradis_torch.tools.soak --workdir DIR --report-only

The port's counterpart of ``scripts/soak.py``: the real CLI
(``python -m paradis_torch.cli.train``) on a synthetic WB2-shaped store
(``--nlat`` × ``--nlon``, 13 levels, ``--times`` six-hourly states from
2000-01-01, preprocessed by ``cli.preprocess``), the JAX script's training
settings (NorMuon, WSD, checkpoints every 100 steps, validation every 2000,
logging and syncs every 40), SIGKILLed once its ``metrics.csv`` passes
``--kill-frac`` of ``--steps`` and resumed with ``init.restart=true`` from
its checkpoints.  ``report`` reads ``metrics.csv`` as the JAX script does:
samples/s over the logged windows, the host RSS slope after warm-up, the
``jit_cache_entries`` column as the port logs it (-1: the port keeps no
compiled-function cache), the losses either side of the resume.  The
``--override``s go to both segments after the script's own (a toy model, a
finer logging cadence).  Writes ``soak_summary.json`` in ``--workdir``.
Each segment runs on ``--device`` (``cuda`` unless given).
"""

from __future__ import annotations

import argparse
import csv
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

LEVELS_13 = [str(v) for v in (50, 100, 150, 200, 250, 300, 400, 500, 600,
                              700, 850, 925, 1000)]
POLL_S = 0.5       # how often the running segment's metrics are read


def sh(cmd, **kw):
    print("+", " ".join(str(c) for c in cmd), flush=True)
    t0 = time.perf_counter()
    subprocess.run([str(c) for c in cmd], check=True, **kw)
    return time.perf_counter() - t0


def build_store(wd: Path, times: int = 1700, nlat: int = 32, nlon: int = 64,
                levels=LEVELS_13):
    py = sys.executable
    if (wd / "prep" / "stats").exists():
        print("store exists, skipping synthesis", flush=True)
        return
    sh([py, "-m", "paradis_torch.data.synthetic", "--out", wd / "raw",
        "--nlat", nlat, "--nlon", nlon, "--times", times,
        "--levels", *levels, "--start", "2000-01-01T00:00:00"])
    sh([py, "-m", "paradis_torch.cli.preprocess", "-i", wd / "raw",
        "-o", wd / "prep"])


def train_cmd(wd: Path, steps: int, batch: int, device: str = "cuda", overrides=()):
    return [sys.executable, "-m", "paradis_torch.cli.train", "--device", device,
            f"dataset.root_dir={wd / 'prep'}",
            "training.dataset.start_date=2000-01-01",
            "training.dataset.end_date=2000-12-31",
            "training.validation_dataset.start_date=2001-01-01",
            "training.validation_dataset.end_date=2001-01-15",
            "training.validation_dataset.validation_batches=8",
            "training.validation_dataset.validation_every_n_steps=2000",
            f"training.dataset.batch_size={batch}",
            "training.dataset.preload=true",
            f"training.max_steps={steps}",
            "training.max_epochs=100000",
            "training.scheduler.wsd.warmup=1000",
            "training.scheduler.wsd.decay=0.2",
            "training.optimizer.name=normuon",
            "training.sync_every_n_steps=40",
            "training.log_every_n_steps=40",
            "training.checkpointing.enabled=true",
            "training.checkpointing.step_every=100",
            f"training.log_dir={wd / 'logs'}",
            "training.progress_bar=false", *overrides]


def metrics_rows(wd: Path):
    rows = []
    path = wd / "logs" / "metrics.csv"
    if not path.exists():
        return rows
    with open(path) as f:
        for r in csv.DictReader(f):
            rows.append(r)
    return rows


def last_step(wd: Path) -> int:
    best = 0
    for r in metrics_rows(wd):
        if r["name"] == "train_loss":
            best = max(best, int(r["step"]))
    return best


def run_until(wd: Path, cmd: list, kill_at: int | None, label: str) -> dict:
    """Run ``cmd`` (``cli.train``); if kill_at is given, SIGKILL once
    metrics pass it."""
    out = {"label": label}
    logf = open(wd / f"train_{label}.log", "ab")
    t0 = time.perf_counter()
    proc = subprocess.Popen([str(c) for c in cmd], stdout=logf, stderr=subprocess.STDOUT)
    try:
        while True:
            rc = proc.poll()
            if rc is not None:
                out["exit"] = rc
                break
            if kill_at is not None and last_step(wd) >= kill_at:
                print(f"[soak] SIGKILL at metrics step {last_step(wd)}", flush=True)
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                out["exit"] = "SIGKILL"
                break
            time.sleep(POLL_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    out["last_step"] = last_step(wd)
    return out


def report(wd: Path, resume_step: int | None) -> dict:
    rows = metrics_rows(wd)
    by_name: dict[str, list[tuple[int, float]]] = {}
    for r in rows:
        try:
            by_name.setdefault(r["name"], []).append(
                (int(r["step"]), float(r["value"])))
        except ValueError:
            continue

    def series(name):
        return sorted(by_name.get(name, []))

    sps = series("samples_per_sec")
    rss = series("host_rss_mb")
    cache = series("jit_cache_entries")
    loss = series("train_loss")
    rep: dict = {"logged_windows": len(sps)}
    if sps:
        vals = [v for _, v in sps]
        n = len(vals)
        rep["samples_per_sec"] = {
            "first_quarter_mean": round(sum(vals[: n // 4 or 1]) / (n // 4 or 1), 2),
            "last_quarter_mean": round(sum(vals[-(n // 4 or 1):]) / (n // 4 or 1), 2),
            "max": round(max(vals), 2), "min": round(min(vals), 2),
        }
    if rss:
        # slope after warmup (first 10% dropped), MB per 1k steps
        tail = rss[max(1, len(rss) // 10):]
        if len(tail) >= 2:
            (s0, v0), (s1, v1) = tail[0], tail[-1]
            rep["rss_mb"] = {
                "after_warmup": round(v0, 1), "final": round(v1, 1),
                "mb_per_1k_steps": round((v1 - v0) / max(1, s1 - s0) * 1000, 3),
            }
    if cache:
        vals = [int(v) for _, v in cache]
        rep["jit_cache_entries"] = {"warmup": vals[min(2, len(vals) - 1)],
                                    "final": vals[-1]}
    if loss and resume_step:
        pre = [v for s, v in loss if s <= resume_step][-5:]
        post = [v for s, v in loss if s > resume_step][:5]
        rep["resume_continuity"] = {
            "kill_resume_step": resume_step,
            "pre_kill_losses": [round(v, 4) for v in pre],
            "post_resume_losses": [round(v, 4) for v in post],
        }
    if loss:
        rep["loss"] = {"first": round(loss[0][1], 4),
                       "final": round(loss[-1][1], 4)}
    val = series("val_loss")
    if val:
        rep["val_loss"] = {str(s): round(v, 4) for s, v in val}
    return rep


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--kill-frac", type=float, default=0.45)
    ap.add_argument("--report-only", action="store_true")
    ap.add_argument("--device", default="cuda", help="device of cli.train")
    ap.add_argument("--times", type=int, default=1700, help="six-hourly states of the store")
    ap.add_argument("--nlat", type=int, default=32)
    ap.add_argument("--nlon", type=int, default=64)
    ap.add_argument("--levels", nargs="+", default=LEVELS_13)
    ap.add_argument("--override", action="append", default=[],
                    help="cli.train override key=value after the script's own (repeatable)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not args.report_only:
        from paradis_torch.tools.flagship import device_of

        device_of(args.device, "soak")
    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)

    state_path = wd / "soak_state.json"
    if args.report_only:
        st = json.loads(state_path.read_text()) if state_path.exists() else {}
        rep = report(wd, st.get("resume_step"))
        print(json.dumps(rep, indent=1))
        return rep
    build_store(wd, args.times, args.nlat, args.nlon, args.levels)
    kill_at = int(args.steps * args.kill_frac)
    cmd = train_cmd(wd, args.steps, args.batch, args.device, args.override)
    seg1 = run_until(wd, cmd, kill_at, "seg1")
    resume_step = seg1["last_step"]
    state_path.write_text(json.dumps({"resume_step": resume_step}))

    # resume: full state from the checkpoints root (follows last.json)
    seg2 = run_until(wd, cmd + [f"init.checkpoint_path={wd / 'logs' / 'checkpoints'}",
                                "init.restart=true"], None, "seg2")
    summary = {"segments": [seg1, seg2],
               "report": report(wd, resume_step)}
    (wd / "soak_summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary, indent=1))
    if seg1["exit"] not in ("SIGKILL", 0) or seg2["exit"] != 0:
        raise SystemExit(f"a segment of cli.train failed: {seg1}, {seg2}; see "
                         f"{wd}/train_seg*.log")
    return summary


if __name__ == "__main__":
    main()
