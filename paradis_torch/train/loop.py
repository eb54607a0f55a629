"""Training orchestration: epochs/steps, validation, checkpoints, watchdogs.

The port's counterpart of ``paradis_tpu/train/loop.py``, the host loop
around the train step (the reference's Lightning Trainer + LitParadis +
callbacks, ``trainer.py``, ``utils/callbacks.py``, ``train.py``):

  * steps/epochs budget (``max_steps`` counts optimizer steps),
  * host-driven LR schedule written into the optimizer before each microbatch,
  * validation every N steps or per epoch, with denormalized report RMSEs,
  * NaN/divergence watchdogs (StopOnNaNTrainLoss, EarlyStopping semantics),
  * three checkpoint retention policies + resume/weights-only restore,
  * per-step wall-time (``dt``) and samples/sec logging, under the JAX loop's
    metric names.

One device a process (``cuda`` unless the caller passes another).  The host
mirrors the optimizer step, so schedules and cadences never read the device;
the one host–device sync is ``float(m["loss"])`` at a sync point
(``need_sync``).

Over several ranks (a process group made by
``distributed.initialize_distributed``, as ``cli.train`` does), the run is
data parallel, the counterpart of the JAX loop's mesh branch
(``paradis_tpu/train/loop.py:88-112``): the global batch is
``compute.batch_size × data`` (the ranks over the spatial axes,
``distributed.rank_grid``), each data rank loads its rows of it, each
spatial rank its block of them, the train step averages the gradients and
the metrics over the ranks (``distributed.DataParallel``; ``compute.fsdp``
shards the parameters and the optimizer state), and only rank 0 writes
``metrics.csv``, the run snapshot and the profiler trace.  Every host-side decision (the NaN check,
validation, early stopping, the plateau controller, checkpoint cadences)
reads the ranks' averaged metrics, so all ranks take it alike and none waits
in a collective that another has skipped.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from paradis_torch import distributed, resolve_device
from paradis_torch.data.dataset import ERA5Dataset
from paradis_torch.data.pipeline import BatchLoader
from paradis_torch.model.paradis import Paradis
from paradis_torch.sphere.geometry import latitude_weights
from paradis_torch.train.checkpoint import CheckpointManager, load_params
from paradis_torch.train.loss import WeightedLoss
from paradis_torch.train.optim import build_optimizer, build_schedule, set_learning_rate
from paradis_torch.train.step import create_train_state, make_eval_step, make_train_step
from paradis_torch.utils.logging import MetricsLogger, grad_statistics, save_run_snapshot
from paradis_torch.utils.tracing import recording, span

log = logging.getLogger("paradis_torch")

_PAGE_BYTES = os.sysconf("SC_PAGE_SIZE")
# the JAX loop's jit_cache_entries where no compiled-function cache exists
# (paradis_tpu/train/loop.py:48-53); the port compiles nothing, and the key
# keeps metrics.csv's columns
_NO_JIT_CACHE = -1


def _host_rss_mb() -> float:
    """Current resident set size in MB (from /proc; 0.0 where unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * (_PAGE_BYTES / 1e6)
    except (OSError, ValueError, IndexError):
        return 0.0


def _waited(loader):
    """The loader's batches, the wait for each inside a ``data_wait`` span."""
    batches = iter(loader)
    while True:
        with span("data_wait"):
            batch = next(batches, None)
        if batch is None:
            return
        yield batch


class _NullMetrics:
    """The metrics logger of a rank other than 0: it writes nothing."""

    def log(self, *args, **kwargs) -> None:
        pass


class NaNLossError(RuntimeError):
    pass


class Trainer:
    """Trains a config end to end on ``device``."""

    def __init__(self, cfg, log_dir: str | None = None, device=None):
        self.cfg = cfg
        self.grid = distributed.rank_grid(cfg)  # raises before any batch
        self.data = self.grid.data  # the data-parallel ranks
        self.rank = distributed.get_rank()
        self.device = resolve_device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer on a CUDA device and none is available; "
                               "pass device='cpu' to train on the CPU")
        self.log_dir = Path(log_dir or cfg.training.log_dir)
        # store, checkpoint and metrics writes on rank 0 only (the reference's
        # rank-0 gating under DDP, trainer.py:478-485)
        self.is_main = distributed.is_main_process()
        if self.is_main:
            self.log_dir.mkdir(parents=True, exist_ok=True)

        # -- data ------------------------------------------------------------
        self.train_ds = ERA5Dataset(
            cfg.dataset.root_dir,
            cfg.training.dataset.start_date,
            cfg.training.dataset.end_date,
            forecast_steps=int(cfg.model.forecast_steps),
            cfg=cfg,
            time_interval=cfg.dataset.sampling_interval,
            preload=bool(cfg.training.dataset.preload),
        )
        val_steps = int(cfg.model.get("val_forecast_steps") or cfg.model.forecast_steps)
        self.val_ds = ERA5Dataset(
            cfg.dataset.root_dir,
            cfg.training.validation_dataset.start_date,
            cfg.training.validation_dataset.end_date,
            forecast_steps=val_steps,
            cfg=cfg,
            time_interval=cfg.dataset.sampling_interval,
            preload=bool(cfg.training.validation_dataset.preload),
        )
        # the global batch: compute.batch_size is a data rank's, as the
        # reference's; a spatial rank loads its block of its data rank's rows
        bs = int(cfg.compute.batch_size) * self.data
        rows = distributed.local_batch_slice(bs, self.grid.d, self.data)
        block = (None if self.grid.spatial == 1 else
                 (self.grid.rows(self.train_ds.lat_size), self.grid.cols(self.train_ds.lon_size)))
        self.train_loader = BatchLoader(
            self.train_ds, bs, shuffle=True, seed=int(cfg.init.get("seed") or 0),
            drop_last=True, device=self.device, rows=rows, block=block,
        )
        self.val_loader = BatchLoader(self.val_ds, bs, shuffle=False, drop_last=True,
                                      device=self.device, rows=rows, block=block)

        # -- model/loss/optimizer ---------------------------------------------
        ds = self.train_ds
        self.model = Paradis.from_config(
            cfg,
            input_dim=ds.num_in_features,
            output_dim=ds.num_out_features,
            lat_deg=ds.lat,
            lon_deg=ds.lon,
            device=self.device,
        )  # weights from init.seed
        self.loss_fn = WeightedLoss.from_config(cfg, ds.lat, ds.dyn_output_features,
                                                nlon=ds.lon_size, device=self.device)
        val_kind = cfg.training.loss_function.get("validation_loss", None)
        self.val_loss_fn = (
            WeightedLoss.from_config(cfg, ds.lat, ds.dyn_output_features,
                                     kind=val_kind, nlon=ds.lon_size, device=self.device)
            if val_kind else self.loss_fn
        )
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("Number of trainable parameters: %s", f"{n_params:,}")
        self.num_parameters = n_params

        if cfg.init.checkpoint_path and not cfg.init.restart:
            log.info("loading weights from %s", cfg.init.checkpoint_path)
            load_params(cfg.init.checkpoint_path, self.model)

        # over ranks: replicated from rank 0, or sharded by whole parameter
        self.parallel = (distributed.DataParallel(self.model,
                                                  fsdp=bool(cfg.compute.get("fsdp", False)),
                                                  grid=self.grid)
                         if distributed.is_initialized() else None)
        self.optimizer = build_optimizer(cfg, self.model, self.parallel)

        report = None
        self.report_features = []
        if cfg.training.reports.enable and ds.report_stats is not None:
            self.report_features = list(cfg.training.reports.features)
            idx = [ds.dyn_output_features.index(f) for f in self.report_features]
            kinds = []
            for f in self.report_features:
                if ds.custom_normalization and "specific_humidity" in f:
                    kinds.append("humidity")
                elif ds.custom_normalization and "precipitation" in f:
                    kinds.append("precip")
                else:
                    kinds.append("zscore")
            report = {
                "indices": np.asarray(idx),
                "std": ds.report_stats["std"],
                "kinds": kinds,
                "q_min": float(ds.q_min),
                "q_max": float(max(ds.q_max, ds.q_min * 2)),
                "lat_weights": latitude_weights(ds.lat).astype(np.float32),
            }
        self.eval_step = make_eval_step(self.model, self.val_loss_fn, cfg, report,
                                        parallel=self.parallel)

        self.state = create_train_state(self.model, self.optimizer, self.parallel)
        self.train_step = make_train_step(self.model, self.loss_fn, cfg, self.optimizer,
                                          parallel=self.parallel)

        # -- schedule / checkpoints / logging ----------------------------------
        max_steps = int(cfg.training.max_steps)
        if max_steps <= 0:
            epochs = max(1, int(cfg.training.max_epochs))
            max_steps = epochs * max(1, len(self.train_loader))
        self.max_steps = max_steps
        self.schedule, self.plateau = build_schedule(cfg, max_steps)

        ck = cfg.training.checkpointing
        self.ckpt = CheckpointManager(
            self.log_dir / "checkpoints",
            keep_steps=int(ck.get("keep_steps", 10)),
            step_every=int(ck.get("step_every", 100)),
            accumulate_grad_batches=int(cfg.training.get("accumulate_grad_batches", 1)),
        )
        if cfg.init.checkpoint_path and cfg.init.restart:
            log.info("resuming full state from %s", cfg.init.checkpoint_path)
            self.ckpt.restore(self.state, cfg.init.checkpoint_path)

        if self.is_main:
            self.metrics = MetricsLogger(self.log_dir)
            save_run_snapshot(self.log_dir, cfg)
        else:
            self.metrics = _NullMetrics()
        self.metrics.log(0, {"model/num_parameters": n_params})

        self.print_losses = bool(cfg.training.get("print_losses", False))
        es = cfg.training.early_stopping
        self._early_stopping = bool(es.enabled)
        self._es_patience = int(es.patience)
        self._es_best = float("inf")
        self._es_bad = 0
        self._checkpointing = bool(cfg.training.checkpointing.enabled)
        self._profiler = None
        self._window = None

    # -- loops -----------------------------------------------------------------

    def fit(self) -> dict:
        try:
            return self._fit()
        finally:
            self._stop_profiler()

    def _fit(self) -> dict:
        cfg = self.cfg
        num_common = self.train_ds.num_common_features
        log_every = int(cfg.training.log_every_n_steps)
        val_every = cfg.training.validation_dataset.validation_every_n_steps
        epoch = 0
        last_val = float("nan")
        stop = False

        pbar = None
        if cfg.training.progress_bar and not cfg.training.print_losses and self.is_main:
            try:  # step-global progress bar (reference utils/callbacks.py:8-128)
                from tqdm import tqdm

                pbar = tqdm(total=self.max_steps, initial=int(self.state.step),
                            desc="train", unit="step")
            except ImportError:
                pbar = None

        while not stop:
            epoch_t0 = time.perf_counter()
            # host↔device sync cadence: 1 = reference-faithful per-step loss
            # checks; >1 lets the host queue steps ahead of the device
            # (metrics stay on the device between sync points).  The host
            # mirrors the step counter so schedules/cadences never read the
            # device.
            sync_every = max(1, int(cfg.training.get("sync_every_n_steps", 1) or 1))
            grad_accum = max(1, int(cfg.training.get("accumulate_grad_batches", 1)))
            micro_host = 0                      # microbatches this epoch
            step0 = int(self.state.step)
            window_t0 = time.perf_counter()
            window_steps = 0
            for batch in _waited(self.train_loader):
                opt_step = step0 + (micro_host // grad_accum)  # completed steps
                lr = self.schedule(opt_step)
                set_learning_rate(self.optimizer, lr)
                m = self.train_step(self.state, batch, num_common)
                micro_host += 1
                window_steps += 1

                step = step0 + (micro_host // grad_accum)
                need_sync = (
                    step % sync_every == 0
                    or step % log_every == 0
                    or (self._checkpointing and step % self.ckpt.step_every == 0)
                    or (val_every and step % int(val_every) == 0)
                    or step <= 1
                    or step >= self.max_steps
                )
                if not need_sync:
                    continue

                with span("sync"):
                    loss = float(m["loss"])  # waits for the device
                dt = (time.perf_counter() - window_t0) / max(1, window_steps)
                window_t0 = time.perf_counter()
                window_steps = 0

                if loss > 10 or not np.isfinite(loss):
                    raise NaNLossError(
                        f"NaN/diverged training loss {loss} at step {step}"
                    )
                self._profiler_tick(step)
                if pbar is not None:
                    pbar.n = step
                    pbar.set_postfix(train_loss=f"{loss:.4f}", lr=f"{lr:.2e}",
                                     refresh=False)
                    pbar.refresh()
                if step % log_every == 0 or step == 1:
                    bsz = batch["input"].shape[0] * self.data  # the global batch
                    self.metrics.log(step, {
                        "train_loss": loss,
                        "lr": lr,
                        "dt": dt,
                        "samples_per_sec": bsz / max(dt, 1e-9),
                        "grad_norm": float(m["grad_norm"]),
                        "forecast_steps": batch["target"].shape[1],
                        # soak observability: host RSS in MB (leak watch);
                        # jit_cache_entries keeps the JAX loop's column
                        "host_rss_mb": _host_rss_mb(),
                        "jit_cache_entries": _NO_JIT_CACHE,
                    })
                    if "grads" in m:
                        self._log_deep_stats(step, m)
                if self._checkpointing:
                    with span("checkpoint"):
                        self.ckpt.maybe_save_step(step, self.state)
                if val_every and step and step % int(val_every) == 0:
                    last_val = self._validate(step)
                    stop = stop or self._early_stop_check(last_val)
                if step >= self.max_steps:
                    stop = True
                if stop:
                    break

            epoch += 1
            if not stop or np.isnan(last_val):
                last_val = self._validate(int(self.state.step))
                stop = stop or self._early_stop_check(last_val)
            if self.plateau is not None:
                self.plateau.update(last_val)
            if self._checkpointing:
                with span("checkpoint"):
                    self.ckpt.save_epoch(epoch, self.state)
                    self.ckpt.maybe_save_best(last_val, self.state)
            max_epochs = int(self.cfg.training.max_epochs)
            if max_epochs > 0 and epoch >= max_epochs:
                stop = True
            log.info("epoch %d done in %.2fs val_loss=%.6f",
                     epoch, time.perf_counter() - epoch_t0, last_val)
            if self.print_losses and self.is_main:
                print(
                    f"Epoch {epoch:4d} | Val Loss: {last_val:.6f} | "
                    f"LR: {self.schedule(int(self.state.step)):.2e} | "
                    f"Elapsed time: {time.perf_counter() - epoch_t0:.4f}s"
                )

        if pbar is not None:
            pbar.close()
        return {"steps": int(self.state.step), "epochs": epoch, "val_loss": last_val}

    def _validate(self, step: int) -> float:
        limit = self.cfg.training.validation_dataset.validation_batches
        num_common = self.val_ds.num_common_features
        losses, reports = [], []
        gathered = self.parallel.gathered() if self.parallel is not None else contextlib.nullcontext()
        with span("validate"), gathered:
            for i, batch in enumerate(self.val_loader):
                if limit is not None and i >= int(limit):
                    break
                out = self.eval_step(batch, num_common)
                losses.append(float(out["loss"]))
                if "report_rmse" in out:
                    reports.append(out["report_rmse"].float().cpu().numpy())
        if not losses:
            return float("nan")
        val = float(np.mean(losses))
        payload = {"val_loss": val}
        if reports:
            mean_rep = np.mean(reports, axis=0)
            for name, value in zip(self.report_features, mean_rep):
                payload[name] = float(value)
        self.metrics.log(step, payload)
        return val

    def _profiler_tick(self, step: int) -> None:
        """``torch.profiler`` trace window around the configured steps,
        written to ``<log_dir>/profile/trace.json``, with the program's spans
        recorded over it (``utils/tracing.py``), so that the trace names
        them."""
        pcfg = self.cfg.training.get("profiler", None)
        if not pcfg or not pcfg.get("enabled") or not self.is_main:
            return
        start = int(pcfg.get("start_step", 10))
        num = int(pcfg.get("num_steps", 5))
        if step == start and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._window = contextlib.ExitStack()
            self._profiler = self._window.enter_context(profile(activities=activities))
            self._window.enter_context(recording(annotate=True))
        elif self._profiler is not None and step >= start + num:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        if self._profiler is None:
            return
        self._window.close()  # the spans' recording, then the profiler
        out = self.log_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        self._profiler.export_chrome_trace(str(out / "trace.json"))
        self._profiler = self._window = None
        log.info("profiler trace written to %s", out)

    def _log_deep_stats(self, step: int, m: dict) -> None:
        """Per-module grad/param stats + per-channel losses
        (reference trainer.py:520-617, 844-923)."""
        grads, sum_across = m["grads"], None
        if self.parallel is not None and self.parallel.fsdp:
            # each rank's own parameters (and their optimizer moments), the
            # sums added over the data group (which holds each one once)
            grads = {n: g for n, g in grads.items() if self.parallel.owns(n)}
            sum_across = self.parallel.sum_
        stats = grad_statistics(grads, self.model, self.optimizer, sum_across=sum_across)
        names = self.train_ds.dyn_output_features
        for key in ("channel_loss_weighted", "channel_loss_unweighted"):
            if key in m:
                vals = m[key].float().cpu().numpy()
                prefix = "train_loss_channel_" + key.rsplit("_", 1)[-1]
                stats.update({f"{prefix}/{n}": float(v)
                              for n, v in zip(names, vals)})
        self.metrics.log(step, stats)

    def _early_stop_check(self, val_loss: float) -> bool:
        if not self._early_stopping or np.isnan(val_loss):
            return False
        if not np.isfinite(val_loss) or val_loss > 1.5:  # divergence_threshold
            log.warning("early stopping: divergent val_loss %.4f", val_loss)
            return True
        if val_loss < self._es_best:
            self._es_best = val_loss
            self._es_bad = 0
            return False
        self._es_bad += 1
        if self._es_bad >= self._es_patience:
            log.info("early stopping: no improvement for %d validations",
                     self._es_bad)
            return True
        return False
