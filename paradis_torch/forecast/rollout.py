"""Autoregressive forecast rollout with chunked host writes.

Port of ``paradis_tpu/forecast/rollout.py``.  ``make_forecast_rollout``: the
model steps once per forcing time step, the lagged input stack shifts after
each step (``forecast_step``, which the exported scanned rollout of
``forecast/export.py`` shares), and every ``output_frequency``-th output is
kept; it runs eagerly under ``torch.inference_mode()`` on the model's
device.  ``run_forecast``: for each batch of init times, one rollout
on the device, one device → host copy of its stored steps, and region writes
of ``forecast.write_every_n`` stored steps at a time to the WB2-layout store
(reference ``predict_step``, ``trainer.py:731-815``).  Over several ranks
each rank forecasts its contiguous share of the init times into the one
store (the counterpart of the JAX ``mesh`` branch, the reference's
inference DP).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from paradis_torch.utils.tracing import span


def autoregress_next_input(dyn_input: torch.Tensor, output: torch.Tensor,
                           num_common: int, n_time_inputs: int) -> torch.Tensor:
    """Shift the lagged common-feature stack and append the new prediction.

    Assumes, like the JAX package, that the per-time dynamic block equals the
    common features.  The result keeps ``dyn_input``'s dtype.
    """
    common = output[..., :num_common].to(dyn_input.dtype)
    if n_time_inputs == 1:
        return common
    lag = num_common * n_time_inputs
    return torch.cat([dyn_input[..., num_common:lag], common], dim=-1)


def forecast_step(model, dyn: torch.Tensor, forcing_t: torch.Tensor, constants: torch.Tensor,
                  num_common: int, n_time_inputs: int):
    """One autoregressive step: the model on dyn, the forcing at t and the
    constants (broadcast to the batch), then the lag shift.  Returns
    ``(next dyn, output)``.  The body of both the eager rollout below and the
    scanned rollout of ``forecast/export.py``, so the two cannot drift."""
    out = model(torch.cat([dyn, forcing_t, constants], dim=-1))
    return autoregress_next_input(dyn, out, num_common, n_time_inputs), out


def make_forecast_rollout(model, cfg):
    """Build ``rollout(batch, num_common_features) -> stored [B, T_stored, H, W, C]``.

    ``batch`` holds ``input [B, H, W, C_dyn]``, ``forcings [B, S, H, W, F]`` and
    ``constants [B, H, W, K]`` on the model's device; the rollout takes S steps
    and returns every ``forecast.output_frequency``-th output in float32.
    """
    n_time = int(cfg.dataset.n_time_inputs)
    out_freq = int(cfg.forecast.output_frequency)
    if out_freq < 1:
        raise ValueError(f"forecast.output_frequency must be >= 1, got {out_freq}")

    def rollout(batch: dict, num_common_features: int) -> torch.Tensor:
        for key in ("input", "forcings", "constants"):
            if batch[key].device != model.device:
                raise ValueError(f"batch[{key!r}] is on {batch[key].device}, "
                                 f"the model on {model.device}")
        with torch.inference_mode(), span("rollout"):
            dyn = batch["input"]
            forcings = batch["forcings"]
            B = dyn.shape[0]
            constants = batch["constants"].expand(B, *batch["constants"].shape[1:])
            stored = []
            for t in range(forcings.shape[1]):
                with span("forecast_step"):
                    dyn, out = forecast_step(model, dyn, forcings[:, t], constants,
                                             num_common_features, n_time)
                if t % out_freq == 0:
                    stored.append(out)
            return torch.stack(stored, dim=1).float()

    return rollout


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DatasetShare:
    """Items ``[lo, hi)`` of a dataset as a dataset of their own: a rank's
    share of the init times.  A prediction dataset's items keep their index
    in the whole dataset, so the writer places each in the one store."""

    def __init__(self, dataset, lo: int, hi: int):
        self.dataset, self.lo, self.hi = dataset, lo, hi
        self.prediction_stage = getattr(dataset, "prediction_stage", False)

    def __len__(self) -> int:
        return self.hi - self.lo

    def __getitem__(self, i: int):
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self.dataset[self.lo + i]


def run_forecast(model, dataset, cfg, writer, batch_loader) -> dict:
    """Forecast every sample of ``batch_loader`` and write the WB2 store of
    ``dataset``.

    ``batch_loader`` is a prediction-mode ``BatchLoader`` on the model's
    device (the rollout raises on a batch elsewhere).  With one process it
    covers ``dataset``.  Over several ranks (a process group, as
    ``cli.forecast --num-devices N`` under the launcher makes) it covers this
    rank's contiguous share (``DatasetShare`` of
    ``distributed.contiguous_share``): rank 0 creates the store, and after a
    barrier every rank writes its own inits' regions.  Those are disjoint:
    the writer's chunks hold one init time each (``chunks=(1, ...)`` in
    ``ZarrForecastWriter.init_store``), so no two ranks touch one chunk file.
    A ragged tail needs no padding: the data ranks share no collective in a
    rollout.  Over spatial axes (``distributed.rank_grid``: the loader gives
    this rank its block of its data rank's share) each rank rolls out its
    block inside ``sphere.partition.spatial_rules``, the blocks are gathered
    over the spatial group after each rollout, and the group's first rank
    copies and writes them.  On a card the native host library is required,
    so that the store's chunks are Blosc-zstd and never the zlib frames its
    absence would give.

    Returns the host-clock seconds of the run and of its parts, for the
    caller to report: ``seconds`` (all of it), ``rollout_s`` (the rollouts,
    to the end of their device work), ``copy_s`` (the device → host copies),
    ``write_s`` (postprocessing and region writes, ``init_store`` included),
    with ``steps`` (forecast steps taken, summed over init times),
    ``samples``, ``copy_bytes`` and ``forecast_steps_per_s`` (steps over
    ``seconds``).  Over several ranks these are this rank's, ``ranks`` lists
    every rank's, and ``total`` holds their sums over the ranks that write
    (``seconds`` the slowest rank's, ``forecast_steps_per_s`` all steps
    over it).
    """
    from paradis_torch import distributed
    from paradis_torch.sphere.partition import spatial_rules

    grid = distributed.rank_grid(cfg)
    world, rank = distributed.world_size(), distributed.get_rank()
    device = model.device
    if device.type == "cuda":
        from paradis_torch.data import native

        native.require()
    start = time.perf_counter()
    rollout = make_forecast_rollout(model, cfg)
    stats = dict(rollout_s=0.0, copy_s=0.0, write_s=0.0, steps=0, samples=0, copy_bytes=0)
    t0 = time.perf_counter()
    if rank == 0:
        writer.init_store(dataset)
    distributed.barrier()  # the store exists before any rank writes
    stats["write_s"] += time.perf_counter() - t0
    write_every = int(cfg.forecast.get("write_every_n") or writer.stored_steps)

    for batch in batch_loader:
        sample_idx = np.asarray(batch.pop("index"))
        t0 = time.perf_counter()
        with spatial_rules(grid):
            stored = rollout(batch, dataset.num_common_features)  # [B, T_stored, H, W, C]
        if grid.spatial > 1:
            stored = grid.gather(stored)
        _sync(device)
        t1 = time.perf_counter()
        stats["steps"] += len(sample_idx) * batch["forcings"].shape[1]
        stats["samples"] += len(sample_idx)
        stats["rollout_s"] += t1 - t0
        if not grid.lead:
            continue
        stored = stored.cpu().numpy()
        t2 = time.perf_counter()
        stored = np.moveaxis(stored, -1, 2)  # [B, T_stored, C, H, W]
        t_total = stored.shape[1]
        for lo in range(0, t_total, write_every):
            hi = min(lo + write_every, t_total)
            writer.write_forecast_chunk(
                forecast=stored[:, lo:hi],
                sample_indices=sample_idx,
                start_idx=lo,
                dataset=dataset,
            )
        stats["copy_s"] += t2 - t1
        stats["write_s"] += time.perf_counter() - t2
        stats["copy_bytes"] += stored.nbytes
    stats["seconds"] = time.perf_counter() - start
    stats["forecast_steps_per_s"] = stats["steps"] / stats["seconds"]
    if world == 1:
        return stats
    import torch.distributed as dist

    stats["lead"] = grid.lead
    ranks = [None] * world
    dist.all_gather_object(ranks, stats)
    total = {k: sum(r[k] for r in ranks if r["lead"]) for k in ("steps", "samples", "copy_bytes")}
    total["seconds"] = max(r["seconds"] for r in ranks)
    total["forecast_steps_per_s"] = total["steps"] / total["seconds"]
    return dict(stats, rank=rank, ranks=ranks, total=total)
