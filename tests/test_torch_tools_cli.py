"""The operating tools end to end, each in a subprocess on the CPU at toy size.

- ``python -m paradis_torch.tools.soak``: a synthetic 8 × 16 store, a
  ``cli.train`` segment SIGKILLed once its ``metrics.csv`` passes the kill
  fraction, the resume from its checkpoints with ``init.restart=true`` to
  the last step; the report's keys (those of ``scripts/soak.py``), the
  losses either side of the resume, ``jit_cache_entries`` as the port logs
  it (-1); ``--report-only`` reads the same report back;
- ``python -m paradis_torch.tools.rehearsal --highres`` at 8 × 16 (366
  six-hourly states: one forecast init in the held-out window): the raw
  store, ``cli.preprocess``, ``cli.train`` in two segments with a resume,
  ``cli.forecast`` and the Z500 / T850 scores at 24, 72 and 120 h in
  ``rehearsal_summary.json`` (the keys of ``scripts/rehearsal.py``).

Each tool is given ``--device cpu`` and a toy model through ``--override``.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TOY = ["features.pressure_levels=[500,850,1000]", "model.latent_size=16",
       "model.velocity_vectors=4", "model.num_layers=2",
       "model.physblock.velocity_net.hidden_dim=8", "model.physblock.reaction.hidden_dim=8",
       "model.physblock.output_proj.hidden_dim=8", "model.bias_channels=2",
       "model.bias_rank=4", "training.scheduler.wsd.warmup=2",
       "training.log_every_n_steps=1"]


def _run(tool: str, *args: str, timeout: int = 400) -> subprocess.CompletedProcess:
    res = subprocess.run([sys.executable, "-m", f"paradis_torch.tools.{tool}", *args],
                         capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res


def _overrides(extra=()):
    return [a for o in [*TOY, *extra] for a in ("--override", o)]


def test_soak_kills_and_resumes_cli_train(tmp_path):
    wd = tmp_path / "soak"
    _run("soak", "--workdir", str(wd), "--device", "cpu", "--steps", "12", "--batch", "1",
         "--kill-frac", "0.45", "--times", "30", "--nlat", "8", "--nlon", "16",
         "--levels", "500", "850", "1000",
         *_overrides(["training.sync_every_n_steps=1", "training.checkpointing.step_every=2",
                      "training.validation_dataset.start_date=2000-01-06",
                      "training.validation_dataset.end_date=2000-01-07"]))
    summary = json.loads((wd / "soak_summary.json").read_text())
    seg1, seg2 = summary["segments"]
    assert seg1["exit"] == "SIGKILL" and 5 <= seg1["last_step"] < 12
    assert seg2["exit"] == 0 and seg2["last_step"] == 12
    rep = summary["report"]
    assert set(rep) >= {"logged_windows", "samples_per_sec", "rss_mb", "jit_cache_entries",
                        "resume_continuity", "loss"}
    assert rep["jit_cache_entries"] == {"warmup": -1, "final": -1}
    cont = rep["resume_continuity"]
    assert cont["kill_resume_step"] == seg1["last_step"]
    assert len(cont["pre_kill_losses"]) == 5 and len(cont["post_resume_losses"]) == 5
    assert all(math.isfinite(v) for v in cont["pre_kill_losses"] + cont["post_resume_losses"])
    again = _run("soak", "--workdir", str(wd), "--report-only")
    assert json.loads(again.stdout) == rep


def test_rehearsal_runs_the_production_loop(tmp_path):
    wd = tmp_path / "reh"
    _run("rehearsal", "--workdir", str(wd), "--device", "cpu", "--highres", "--nlat", "8",
         "--nlon", "16", "--times", "366", "--steps", "4",
         *_overrides(["training.validation_dataset.validation_batches=1",
                      "training.scheduler.wsd.warmup=1"]))
    summary = json.loads((wd / "rehearsal_summary.json").read_text())
    assert set(summary) == {"steps", "grid", "device", "synthesize_s", "preprocess_s",
                            "train_seg1_s", "train_seg2_s", "train_samples_per_sec",
                            "forecast_s", "rmse"}
    assert summary["steps"] == 4 and summary["grid"] == "8x16"
    rows = (wd / "logs" / "metrics.csv").read_text().splitlines()
    steps = sorted({int(r.split(",")[0]) for r in rows[1:] if ",train_loss," in r})
    assert steps == [1, 2, 3, 4]          # two in each segment, the second resumed
    for var in ("geopotential_h500", "temperature_h850"):
        for lead in (24, 72, 120):
            assert math.isfinite(summary["rmse"][f"{var}@{lead}h"])


def test_a_loader_left_early_leaves_no_worker_running(tmp_path):
    """A ``cli.train`` segment of the rehearsal once ended in SIGABRT
    ("terminate called without an active exception") after its validation
    loader, left after one batch, still had its workers running at the
    interpreter's shutdown.  The loader now joins its workers when its
    iteration ends."""
    import threading

    from paradis_torch.data.dataset import ERA5Dataset
    from paradis_torch.data.pipeline import BatchLoader
    from torch_toy import build_torch_toy_store, torch_toy_config

    store = build_torch_toy_store(tmp_path)
    ds = ERA5Dataset(str(store), "2000-01-01", "2000-01-05", forecast_steps=1,
                     cfg=torch_toy_config(store))
    before = set(threading.enumerate())
    for _ in zip(range(1), BatchLoader(ds, 1, shuffle=True, device="cpu")):
        pass
    assert set(threading.enumerate()) <= before
