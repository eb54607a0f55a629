"""Training observability: CSV metrics, run snapshots.

The port's counterpart of ``paradis_tpu/utils/logging.py``: the same
``metrics.csv`` (``step,name,value`` rows), the same run snapshot (the
resolved config and the git state of the repository the port sits in) and
the same per-module gradient statistics, bucketed by the JAX package's
top-level parameter key so that the ``grad/…``, ``pnorm/…``,
``gradratio/…`` and ``grad_alignment/…`` names are the ones JAX logs for the
same model.  The JAX logger also mirrors to TensorBoard (``tb/``); the port
writes no TensorBoard events, ``metrics.csv`` is its only record.
"""

from __future__ import annotations

import csv
import json
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch


class MetricsLogger:
    """Append-only CSV metrics: ``metrics.csv`` with ``step,name,value`` rows."""

    def __init__(self, log_dir: str):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._csv_path = self.dir / "metrics.csv"
        self._file = open(self._csv_path, "a", newline="")
        self._writer = csv.writer(self._file)
        if self._csv_path.stat().st_size == 0:
            self._writer.writerow(["step", "name", "value"])

    def log(self, step: int, metrics: dict) -> None:
        for name, value in metrics.items():
            self._writer.writerow([step, name, float(value)])
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def optimizer_momentum(optimizer) -> dict[str, torch.Tensor] | None:
    """The first moment the JAX loop finds in its optimizer state
    (``paradis_tpu/train/loop.py:393-403``), by parameter name.

    The JAX loop takes the first ``mu`` / ``momentum`` among the top-level
    entries of its optax chain.  Under ``adamw`` that is Adam's ``mu`` of
    every parameter, here AdamW's ``exp_avg``; under ``muon`` / ``normuon``
    the chain holds a ``multi_transform`` state whose inner Muon and Adam
    states the search does not enter, so it finds none and no
    ``grad_alignment`` is logged.  The port does the same.
    """
    if optimizer.name != "adamw" or optimizer.adamw is None:
        return None
    params = optimizer.adamw.param_groups[0]["params"]
    out = {}
    for name, p in zip(optimizer.adamw_names, params):
        st = optimizer.adamw.state.get(p)
        if st and "exp_avg" in st:
            out[name] = st["exp_avg"]
    return out


def grad_statistics(grads: dict, model: torch.nn.Module, optimizer=None,
                    sum_across=None) -> dict:
    """Grad/param norms, their ratio and the grad-momentum cosine
    (reference trainer.py:844-923), bucketed as the JAX package buckets them:
    by the first key of each parameter's tree path.  That key is ``params``
    for every leaf of the JAX tree, so there is one bucket, ``params``.

    ``grads`` maps parameter names to gradients (the train step's
    ``metrics["grads"]``).  Sums are float64; one host copy at the end.
    ``sum_across`` (a sharded run): ``grads`` are this rank's parameters',
    and the sums are added over the ranks before the norms.
    """
    if not grads and sum_across is None:
        return {"grad/total": 0.0}
    named = dict(model.named_parameters())
    momentum = optimizer_momentum(optimizer) if optimizer is not None else None
    rows = []
    for name, g in grads.items():
        g64 = g.detach().double()
        terms = [(g64 * g64).sum(), named[name].detach().double().square().sum()]
        if momentum is not None and name in momentum:
            m64 = momentum[name].detach().double()
            terms += [(m64 * m64).sum(), (m64 * g64).sum()]
        else:
            terms += [g64.new_zeros(()), g64.new_zeros(())]
        rows.append(torch.stack(terms))
    dev = next(model.parameters()).device
    sums = torch.stack(rows).sum(0) if rows else torch.zeros(4, dtype=torch.float64, device=dev)
    if sum_across is not None:
        sums = sum_across(sums)
    g2, p2, m2, gm = sums.cpu().numpy()

    eps = 1e-12
    gn, pn = np.sqrt(g2), max(np.sqrt(p2), eps)
    out = {"grad/total": float(gn), "grad/params": float(gn),
           "pnorm/params": float(pn), "gradratio/params": float(gn / pn)}
    if m2 > 0:
        out["grad_alignment/params"] = float(gm / (gn * np.sqrt(m2) + eps))
    return out


def save_run_snapshot(log_dir: str, cfg, repo_root: Optional[str] = None) -> None:
    """Persist the resolved config and the git state of the code
    (reference utils/system.py:46-121)."""
    d = Path(log_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.yaml").write_text(cfg.to_yaml())
    info = {}
    try:
        root = repo_root or str(Path(__file__).resolve().parents[2])
        rev = subprocess.run(["git", "-C", root, "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        info["commit"] = rev.stdout.strip()
        diff = subprocess.run(["git", "-C", root, "diff", "HEAD"],
                              capture_output=True, text=True, timeout=10)
        if diff.stdout:
            (d / "uncommitted.diff").write_text(diff.stdout)
            info["dirty"] = True
    except Exception as e:  # git may be absent in deployment images
        info["error"] = str(e)
    (d / "git_info.json").write_text(json.dumps(info, indent=1))
