"""Training and evaluation steps: autoregressive rollout, TBPTT, accumulation.

Port of ``paradis_tpu/train/step.py``.  A train step rolls the model over the
``S`` target steps of a batch, feeding each output's common features back as
the next input (``autoregress_next_input``):

* truncated backpropagation through time: every ``detach_gradient_every``
  steps the segment's loss is backpropagated and the carried input detached
  (one segment of ``S`` steps when unset);
* each step's loss is scaled by ``1/(S · accumulate_grad_batches)``, so the
  gradients summed over an accumulation window are those of the mean loss;
* the optimizer applies every ``accumulate_grad_batches`` microsteps; the
  gradients accumulate in the parameters' ``.grad`` in between.

Batch layout (channels-last, on the model's device): ``input [B,H,W,C_dyn]``,
``target [B,S,H,W,C_out]``, ``forcings [B,S,H,W,F]``, ``constants [B,H,W,K]``.
Metrics stay on the device (no host sync): ``loss``, ``loss_per_step [S]``,
``grad_norm`` (0 on a step that does not apply) and ``applied``, plus under
``training.log_additional_stats`` the microstep's raw (unclipped) gradients
by parameter name and the first step's per-channel weighted and unweighted
losses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from paradis_torch.distributed import DataParallel, all_reduce_mean
from paradis_torch.forecast.rollout import autoregress_next_input
from paradis_torch.sphere.partition import spatial_mean, spatial_rules
from paradis_torch.train.optim import ParadisOptimizer
from paradis_torch.utils.normalization import denormalize_humidity, denormalize_precipitation
from paradis_torch.utils.tracing import span


@dataclass
class TrainState:
    """The model (its parameters), the optimizer (its state) and the counters;
    over several ranks also how the parameters are laid out on them."""

    model: nn.Module
    optimizer: ParadisOptimizer
    step: int = 0          # optimizer steps taken
    micro_step: int = 0    # microbatches seen (for gradient accumulation)
    parallel: DataParallel | None = None


def create_train_state(model: nn.Module, optimizer: ParadisOptimizer,
                       parallel: DataParallel | None = None) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, parallel=parallel)


def _model_input(dyn, forcing_t, constants):
    return torch.cat([dyn, forcing_t, constants.expand(dyn.shape[0], *constants.shape[1:])],
                     dim=-1)


def make_train_step(model: nn.Module, loss_fn, cfg, optimizer: ParadisOptimizer,
                    parallel: DataParallel | None = None) -> Callable:
    """Build ``train_step(state, batch, num_common_features) -> metrics``.

    The step updates ``state`` (the model's parameters, the optimizer's state
    and the counters) in place.

    Over several ranks (``parallel``), ``batch`` holds this rank's rows of
    the global batch.  Each parameter's gradient is averaged over the ranks
    once an applied step, just before the optimizer (so clipping,
    ``grad_norm`` and the logged raw gradients see the global batch's, as
    under the JAX mesh), and ``loss`` / ``loss_per_step`` (and the logged
    microstep gradients) are the ranks' mean, on the device.  Sharded
    (``compute.fsdp``), the parameters are gathered before the window's first
    forward and released after the update.  Over spatial axes
    (``parallel.grid``) ``batch`` holds this rank's block of its rows, the
    step runs inside ``sphere.partition.spatial_rules`` (the JAX
    ``make_train_step(mesh=...)``), each rank's loss is the whole field's,
    and the gradients are summed over the spatial group before the data
    average (``DataParallel.average_gradients``), so every rank applies the
    one update.
    """
    n_time = int(cfg.dataset.n_time_inputs)
    grad_accum = int(cfg.training.get("accumulate_grad_batches", 1))
    detach_every = cfg.training.optimizer.get("detach_gradient_every", None)
    deep_stats = bool(cfg.training.get("log_additional_stats", False))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    grid = parallel.grid if parallel is not None else None

    def train_step(state: TrainState, batch: dict, num_common_features: int) -> dict:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the train state holds another model or optimizer than this step")
        with span("train_step"), spatial_rules(grid):
            return _train_step(state, batch, num_common_features)

    def _train_step(state: TrainState, batch: dict, num_common_features: int) -> dict:
        targets, forcings, constants = batch["target"], batch["forcings"], batch["constants"]
        S = targets.shape[1]
        seg = max(1, min(int(detach_every or S), S))
        scale = 1.0 / (S * grad_accum)

        if state.micro_step % grad_accum == 0:
            with span("zero_grad"):
                model.zero_grad()  # every parameter's, the rank's own or not
        if parallel is not None:
            parallel.gather()
        before = ({n: p.grad.clone() for n, p in named if p.grad is not None}
                  if deep_stats else None)
        dyn = batch["input"]
        losses, diag0 = [], None
        for lo in range(0, S, seg):
            total = 0.0
            for t in range(lo, min(lo + seg, S)):
                with span("forward"):
                    out = model(_model_input(dyn, forcings[:, t], constants))
                with span("loss"):
                    loss_t = loss_fn(out, targets[:, t])
                if deep_stats and t == 0:
                    with torch.no_grad():
                        diag0 = (loss_fn.per_channel(out, targets[:, 0], weighted=True),
                                 loss_fn.per_channel(out, targets[:, 0], weighted=False))
                losses.append(loss_t.detach())
                total = total + loss_t
                dyn = autoregress_next_input(dyn, out, num_common_features, n_time)
            with span("backward"):
                (total * scale).backward()
            dyn = dyn.detach()

        losses_all = torch.stack(losses)
        if parallel is not None:
            losses_all = all_reduce_mean(losses_all)
        metrics = {"loss": losses_all.mean(), "loss_per_step": losses_all}
        if deep_stats:
            # this microstep's raw gradients, read before the optimizer's
            # gradient clip scales ``.grad`` in place
            grads = {n: (p.grad - before[n] if n in before else p.grad.clone())
                     for n, p in named if p.grad is not None}
            metrics["grads"] = (all_reduce_mean(grads, parallel.grid.data)
                                if parallel is not None else grads)
            diag0 = dict(zip(("channel_loss_weighted", "channel_loss_unweighted"), diag0))
            metrics.update(all_reduce_mean(diag0) if parallel is not None else diag0)
        state.micro_step += 1
        applied = state.micro_step % grad_accum == 0
        if applied:
            if parallel is not None:
                parallel.average_gradients()
            with span("optimizer"):
                gnorm = optimizer.grad_norm()
                optimizer.step()
            state.step += 1
            if parallel is not None:
                parallel.release()
        else:
            gnorm = torch.zeros((), device=losses_all.device)
        metrics.update(grad_norm=gnorm, applied=applied)
        return metrics

    return train_step


def make_eval_step(model: nn.Module, loss_fn, cfg, report: dict | None = None,
                   parallel: DataParallel | None = None) -> Callable:
    """Validation rollout: ``eval_step(batch, num_common_features) -> {loss[,
    report_rmse]}``.

    ``report`` carries ``indices`` (output channels), ``std`` (their
    denormalisation scales) and ``lat_weights`` ([H]), and optionally
    ``kinds`` ("zscore" | "humidity" | "precip" per channel) with ``q_min``
    and ``q_max``, so humidity and precipitation report channels use their
    physical inverse maps.  ``report_rmse`` is the latitude-weighted RMSE per
    report channel in physical units, over all steps.  Over several ranks
    (``parallel``) the loss and the mean squared errors are averaged over the
    ranks before the square root: the global batch's, as under the JAX mesh.
    Over spatial axes each rank evaluates its block of its rows, inside
    ``sphere.partition.spatial_rules``, and its loss and errors are the whole
    field's.
    """
    n_time = int(cfg.dataset.n_time_inputs)

    def denorm(vals: torch.Tensor) -> torch.Tensor:
        kinds = report.get("kinds")
        std = torch.as_tensor(report["std"], dtype=torch.float32, device=vals.device)
        if kinds is None:
            return vals * std
        cols = []
        for j, kind in enumerate(kinds):
            col = vals[..., j]
            if kind == "humidity":
                col = denormalize_humidity(col, float(report["q_min"]), float(report["q_max"]))
            elif kind == "precip":
                col = denormalize_precipitation(col)
            else:
                col = col * std[j]
            cols.append(col)
        return torch.stack(cols, dim=-1)

    grid = parallel.grid if parallel is not None else None

    @torch.inference_mode()
    def eval_step(batch: dict, num_common_features: int) -> dict:
        with spatial_rules(grid):
            return _eval_step(batch, num_common_features)

    def _eval_step(batch: dict, num_common_features: int) -> dict:
        targets, forcings, constants = batch["target"], batch["forcings"], batch["constants"]
        dyn = batch["input"]
        losses, mses = [], []
        for t in range(targets.shape[1]):
            out = model(_model_input(dyn, forcings[:, t], constants))
            losses.append(loss_fn(out, targets[:, t]))
            if report is not None:
                idx = torch.as_tensor(report["indices"], device=out.device)
                lat_w = torch.as_tensor(report["lat_weights"], dtype=torch.float32,
                                        device=out.device)
                if grid is not None and grid.spatial > 1:
                    lat_w = lat_w[grid.rows(len(lat_w))]
                diff = denorm(out[..., idx].float()) - denorm(targets[:, t][..., idx].float())
                mses.append(spatial_mean(diff * diff * lat_w[None, :, None, None],
                                         dim=(0, 1, 2)))
            dyn = autoregress_next_input(dyn, out, num_common_features, n_time)
        res = {"loss": torch.stack(losses).mean()}
        if report is not None:
            res["report_mse"] = torch.stack(mses).mean(dim=0)
        if parallel is not None:
            res = all_reduce_mean(res)
        if report is not None:
            res["report_rmse"] = res.pop("report_mse").sqrt()
        return res

    return eval_step
