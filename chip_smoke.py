#!/usr/bin/env python3
"""Smoke run of paradis_torch on one CUDA card: build, check, forecast, train.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. the card's name and power limit (``nvidia-smi``) and the CUDA version;
2. build every CUDA source of ``paradis_torch/csrc`` with ``nvcc`` and print
   the build time and the compiler's register/spill report;
3. hold the interpolation kernel against its plain PyTorch version at the
   5.625° flagship shapes (field [1, 36, 68, 768], positions
   [1, 32, 64, 768], a share of them outside the field), bicubic and
   bilinear, float32 and bfloat16, plus an odd P·V tail shape, and bitwise
   against the row-chunked kernel (``rw = 8``); print the route it takes
   (bicubic ``resident``: each channel group's whole field in shared
   memory, or ``window``: each tile's row window; ``bilinear``: the route
   of ``csrc/interp_bilinear.cuh``, which every bilinear case of phases 3–5
   and ``[kernel-chunk*]`` takes); time the kernel, the row-chunked
   kernel, the plain version and ``F.grid_sample`` (a yardstick the port
   never calls) with CUDA events, beside the kernel's memory/compute bound;
4. hold the interpolation backward kernel against its plain backward at the
   same shapes (the cotangent a seeded normal in the field's dtype), plus a
   bilinear case with every position on an integer (where K′ is zero at the
   kinks), and, on d_py and d_px bitwise, against the row-chunked backward
   (``rw = 8``; both launch one row-slab kernel); time the kernel, the
   row-chunked kernel, the plain backward and the backward of
   ``F.grid_sample`` (``torch.autograd.grad``, a yardstick the port never
   calls), beside the backward's memory/compute bound;
5. the row-banded pair at the 1.40625° shapes (field [1, 132, 260, 768]
   bicubic and [1, 130, 258, 768] bilinear, positions [1, 128, 256, 768]
   as above, clamped to the bound ``compute.interp_band_rad=0.3`` gives on
   that grid, 12.2 px), float32 and bfloat16, plus an odd tail shape where
   the band gate is on: forward and backward held against the banded plain
   versions and against the unbanded kernels on the same clamped positions
   (the forward, d_py and d_px bitwise: both launch the same kernels, the
   banded ones with a band filter that removes no tap under the clamp);
   timed beside the unbanded kernel, the plain version, ``F.grid_sample``
   (forward and backward) and the bound.  Then ``[kernel-band-outside]``,
   untimed, at the same shapes on rows not clamped (30% pushed 5–20 px
   beyond the bound, some NaN and inf): the banded pair against its plain
   versions, unlike the unbanded kernels where a tap leaves its band and
   bitwise equal to them where none does, zero where no tap row is kept;
6. the serving path: the full-width flagship ``Paradis`` (latent 1024, 768
   velocity vectors, 8 layers, bicubic, fast departure trig) built from
   ``configs/default.yaml`` with seeded random weights
   (``paradis_torch/tools/flagship.py``, which builds every config-built
   model here), runs a 40-step forecast rollout at batch 1 in float32 and in
   bfloat16 through ``make_forecast_rollout``, timed by
   ``tools/bench_forecast``'s protocol (``FORECAST_CHAIN``: one timed
   rollout).  Outputs must be finite, the kernel's launch
   count must rise by exactly 8 × 40 per rollout, and the first step must
   agree with the same model routed through the plain interpolation.  Then
   the same at 1.40625° (128 × 256) with ``compute.interp_band_rad=0.3``:
   the banded kernel must run exactly 8 × 40 times per rollout and the
   unbanded one never.  The field and positions of the 5.625° rollouts'
   first-step launches are recorded (``recording_fwd``, a wrapper of
   ``interp_cuda.interp_fwd_cuda`` in this script only) and, in
   ``[kernel-rollout]``, the kernel is held on them against its plain
   version and, bitwise, against the row-chunked kernel, with the
   departure points' distance from their arrival points (p50, p99, max) and
   the share of taps outside the field, and timed beside the row-chunked
   kernel, ``F.grid_sample``, the plain version and the bound (the weights
   are seeded random: the repo has no trained checkpoint);
7. the training path: the same flagship in the configuration
   ``configs/default.yaml`` trains (bf16 compute with fp32 parameters,
   NorMuon with bf16 Newton–Schulz, weighted reversed Huber with latitude
   weights, 1 forecast step, batch 1; and the same in float32 with
   ``compute.use_amp=false``) takes ``TRAIN_STEPS`` steps through
   ``make_train_step`` on one seeded random batch, on the WSD schedule with a
   short warmup.  Losses and gradient norms must be finite, the last loss
   below the first, each step must launch the forward and the backward
   kernel exactly 8 × S times, and the first step's parameter gradients must
   agree with those through the plain interpolation.  Then the same at
   1.40625° with ``compute.interp_band_rad=0.3`` and
   ``compute.gradient_checkpointing=true`` for ``HR_TRAIN_STEPS`` steps, the
   steps after the first timed as one chain by ``tools/bench_highres``'s
   protocol: each
   step launches the banded forward 16 times (8, and 8 in the backward's
   replay), the banded backward 8 times and the unbanded kernels never.
   ``[train-remat]``: the same bf16 1.40625° steps under
   ``compute.remat_policy=advect`` and ``advect_pos`` (the replay keeps the
   interpolation's output, and its departure positions), each launching the
   banded forward only 8 times a step, with its device ms, busy share,
   launches and peak memory beside the ``none`` run's.  ``[train-amse]``: the
   same bf16 1.40625° steps with ``training.loss_function.type=amse`` (the
   spectral loss through ``ops/sht.py``: an rFFT and a float32 Legendre
   product, no kernel of its own), beside the reversed Huber run.  ``[sht]``:
   the analysis of a seeded [1, 128, 256, 97] field against a float64 CPU
   analysis, and the analysis and the AMSE forward + backward timed beside
   the Legendre product's bound.  ``[checkpoint]``: two uninterrupted
   4-step bf16 1.40625° runs from one seed (their spread is the noise floor
   of the banded backward's float atomics), a third saved after 2 steps
   through ``CheckpointManager``, restored into a model and optimizer built
   afresh from another seed (bitwise what was saved) and run 2 more steps
   (within 4× the spread), the save and restore seconds and bytes, and a
   weights-only ``load_params`` of that checkpoint into a 5.625° model (U/V
   re-interpolated) that forecasts one finite step through #1.
   The device profiles are ``tools/profile_step``'s ``device_profile`` and
   the kernels' bounds ``tools/roofline``'s ``bound`` / ``bound_bwd``.
   ``[data]``: the native host library (required), synthetic WB2-shaped raw
   stores at 1.40625° and 5.625° (13 levels, 20 six-hourly times,
   Blosc-LZ4) built and preprocessed with the port's own pipeline (in the
   process that prepares ``[export]``, while the 1.40625° phases run), the
   median time to assemble one 1.40625° sample, one batch to the card
   pinned and pageable, and the loader's batch on the card bitwise against
   the same batch as numpy.  ``[train-loop]``: ``python -m
   paradis_torch.cli.train`` (its ``main``) on those stores at full width:
   10 bf16 1.40625° steps with validation and step checkpoints every 4 and
   a profiler window (the JAX loop's metric names, the JAX checkpoint
   layout, #5 and #6 16 and 8 times a step, samples/s through the loop
   beside the device-resident rate above, the device busy share, the
   synchronizing operations a step), a resume from its own checkpoints for
   2 more, 8 steps at ``sync_every_n_steps=4`` with no synchronizing
   operation between sync points, and 10 steps at 5.625° through #1 and #2.
   ``[profile-live]``: ``tools/profile_live`` on the 5.625° store
   (``PROFILE_LIVE_ARGS``), the live loop's host phases, #1 and #2 8 times a
   step; ``[ns-convergence]`` / ``[lq-convergence]``:
   ``tools/ns_convergence`` (one seed) and ``tools/lq_convergence`` for
   ``CONVERGENCE_STEPS`` steps of their toy model on their 8 × 16 store,
   finite losses, #1 and #2 2 times a step of each run.
   ``[forecast-io]``: ``python -m paradis_torch.cli.forecast`` (its
   ``main``) on the card from synthetic WB2-shaped stores of 48 (5.625°, 2
   init times 36 h apart) and 42 (1.40625°, 1 init time, banded) six-hourly
   times built and preprocessed here, with the seeded flagship's weights
   saved by ``save_params``: 40 fp32 steps, batch 1, writes every 10 stored
   steps.  The native library is required and every chunk's Blosc header
   must name zstd; the store read back must be within a BitRound(16) step
   of the same batches rolled out in memory and put through the port's
   postprocessing, finite, its dewpoint depression ≤ 30 and its
   output-only channels NaN at td 0 and finite after; #1 must run 640 times
   at 5.625° and #5 320 at 1.40625°; ``evaluate_store`` on the store against
   the raw and the preprocessed truth must give finite RMSEs at 24, 72 and
   120 h.  Forecast steps/s through the CLI beside the in-memory rollout's
   (device-only) rate, the write, copy and evaluate seconds, the store
   build and preprocess seconds.  ``[export]``: the serving artifact: at
   5.625° ``cli.export`` at its default ``--device cuda`` (in a process
   of its own, started with [forecast-io]'s stores and weights before
   ``[train-remat]``, whose 1.40625° phases keep the card busy) turns
   ``[forecast-io]``'s checkpoint into ``forward.pt2`` and the scanned
   ``rollout.pt2`` (``torch.export``, the parameters an input) with
   ``params.npz``, and ``paradis_torch.tools.bench_artifact --artifact``
   loads it (``load_artifact``) and runs 40 steps through the artifact's
   rollout, its forward a step at a time and the in-process rollout, in
   alternating turns; at 1.40625° (``interp_band_rad=0.3``) the same
   process exports the forward program alone, and the bench loads it and
   runs it a step at a time beside the in-process rollout: #1 320 times a call of each way (8 a
   ``forward.pt2`` call), #5 80 (10 steps), each artifact way within ``EXPORT_TOL``
   of the largest output of the in-process rollout, the band plan in the
   1.40625° graph; export and load seconds, file bytes and steps/s of each
   way.  ``[bench-model]``: ``paradis_torch.tools.bench_model`` at its
   defaults but ``BENCH_MODEL_REPEATS`` (the bf16 flagship at 5.625°, batch
   1; ``xla`` and ``pallas``,
   ``fwd`` and ``bwd``; chain slopes, the impls in turns): the four ms and
   the first calls' seconds; #1 launched 8 times a ``pallas`` ``fwd`` call,
   #1 and #2 8 times each a ``pallas`` ``bwd`` call, neither in the ``xla``
   rows.  ``[multi-gpu]``: the runs in three launches of ``python -m
   torch.distributed.run`` (this script's ``--worker`` mode: for each run of
   the launch the entry point's ``main``, then the rank's launch counts; the
   runs of a launch share its process group): (a), (c) and (c)'s resume in
   one launch, (b) beside it, then (d), on ``[data]``'s
   5.625° store, bf16, full width and depth: (a) ``cli.train`` on 2 ranks
   sharing the card over gloo, batch 1 a rank, against (b) 1 rank over
   NCCL (its initialisation and all-reduce on the card) with batch 2, the
   same seed, ``MG_STEPS`` steps: each step's loss within ``MG_LOSS_RTOL``,
   only rank 0's ``metrics.csv`` and checkpoints (the files of a one-process
   run, ``MG_RUN_FILES``), #1 and #2 8 times a step
   on each rank; (c) ``compute.fsdp=true`` on 2 gloo ranks, 2 training
   samples (a resumed run's fresh epoch order then changes nothing):
   ``2 × MG_FSDP_K`` steps saving a sharded checkpoint after ``MG_FSDP_K``,
   and a resume from it for ``MG_FSDP_K`` more, the losses within
   ``MG_LOSS_RTOL`` of each other; (d)
   ``cli.forecast --num-devices 2`` on 2 gloo ranks with ``[forecast-io]``'s
   5.625° store and weights, beside (c): every array equal to
   that phase's one-process store.  Seconds and samples/s of each run (runs
   side by side share the card and the host's cores).  ``[spatial]``: one
   launch of 2 gloo ranks started beside ``[multi-gpu]``'s (``start_spatial``),
   on the ``data × lat × space`` grid of ranks: (e) ``cli.train`` with
   ``compute.lat_devices=2`` and (f) with ``compute.spatial_devices=2``,
   ``MG_STEPS`` steps of (a)'s configuration with the global batch of 2 on
   each rank's block, each step's loss within ``MG_LOSS_RTOL`` of (b), #1
   and #2 8 times a step on each rank; (g) ``cli.forecast`` with
   ``compute.lat_devices=2``, ``SPATIAL_FC_STEPS`` float32 steps at 1.40625°
   on ``[forecast-io]``'s store and weights, within a BitRound(16) step plus
   ``SPATIAL_FC_TOL`` of each variable's largest value of that phase's
   one-process store, #1 (the band's clamped positions; not #5) 8 times a
   step on each rank; the seconds a step beside the one process's.
   ``[spatial-fsdp]``: after ``[spatial]``, one launch of 4 gloo ranks, (h)
   ``cli.train`` with ``compute.fsdp=true compute.lat_devices=2`` (``data 2
   × lat 2``), (e)'s configuration and global batch, ``MG_STEPS`` steps, a
   sharded checkpoint after ``MG_FSDP_K``: each step's loss within
   ``MG_LOSS_RTOL`` of (b), #1 and #2 8 times a step on each rank, one
   shard a data rank written by the lead spatial position's ranks alone
   and read back whole into the flagship; seconds a step beside (e)'s.
   ``[bench-pipeline]``, ``[roofline]``: what the process that prepared
   ``[export]`` ran after ``cli.export`` (``host_tools``):
   ``tools/bench_pipeline`` on [data]'s stores, the host path and with the
   place stage to the card, and ``tools/roofline --cost`` at both grids (one
   train step on meta tensors under ``FlopCounterMode``, the custom ops
   counted, within 10% below to 1% above the analytic sum).
   The field, positions and cotangent of the 5.625° train steps' first-step
   backward launches are recorded (``recording_bwd``) and, in
   ``[kernel-bwd-train]``, the backward kernel is held on them against its
   plain version and, on d_py and d_px bitwise, against the row-chunked
   backward, and timed beside it, the backward of ``F.grid_sample``, the
   plain version and the bound;
8. the row-chunked pair (``[kernel-chunk]``) at the 5.625° shapes with
   ``rw = 8``, at the 1.40625° shapes with ``rw = 32`` and at an odd tail
   shape whose last chunk has 5 rows, float32 and bfloat16, on random
   positions and on departure-like ones (clamped to the bound
   ``compute.interp_band_rad=0.3`` gives on the grid): forward and backward
   held against the plain versions and against the unbanded kernels (the
   forward bitwise, and d_py, d_px bitwise), timed on the departure-like
   positions beside the unbanded and banded kernels, the plain version,
   ``F.grid_sample`` and the bound; and the weight-generation pair
   (``[kernel-gen]``) against its plain versions, bicubic and bilinear, at
   the microbenchmark's shapes (timed beside its bound) and, untimed, at a
   tail shape whose element count is no multiple of 4 and on positions one
   element into their buffers (not 16-byte aligned);
9. the same serving and training paths with ``PARADIS_INTERP_CHUNK`` set
   for the phase: a 40-step float32 rollout and bfloat16 train steps at
   5.625° (``rw = 8``) and at 1.40625° (``rw = 32``, no band, the train
   steps with gradient checkpointing), each launching the chunked kernels
   exactly as the unbanded ones above and no other interpolation kernel;
   ``[device-ms]`` then prints the device ms a step of the forecasts and of
   every train cell beside this script's earlier figures
   (``EARLIER_DEVICE_MS``); ``[bilinear-paths]`` then takes the model's
   bilinear paths (``model.adv_interpolation=bilinear``) once each, through
   ``bench_forecast`` (a 4-step float32 rollout) and ``bench_highres`` (a
   bfloat16 and a float32 train step), unbanded at 5.625°, banded at
   1.40625° and row-chunked at both, each launching its entry points only,
   as often as its 8 layers take them: the launches of the kernels line's
   bilinear records;
10. the contraction kernels of the microbenchmark (``[kernel-mm]``):
    ``mm`` (float32 and bfloat16 operands, each variant's channel and
    position blocks), ``mmT`` (bfloat16, the variant's, and float32) and
    ``bwd_mm`` (bfloat16 operands on a bfloat16 and a float32 field, float32
    operands on either) against their plain versions at the
    microbenchmark's shapes (B·V 768, P 2048, R 36, C 68) and at a tail
    shape (V 77, P 1000, R 13, C 22), timed beside the same work through
    ``torch.matmul`` / ``torch.bmm`` and the bound; ``bwd_mm`` run twice to
    the same bits; for each operand type, ``mm``'s and ``mmT``'s outputs
    bitwise equal across the variants' and four more channel and position
    blocks on one set of operands (their grid is their own);
11. the dense interpolation path (``[forecast-dense]``): a 40-step float32
    rollout at 5.625° with ``compute.advection_impl=xla``, which launches no
    interpolation kernel, its first step against the plain path; then
    ``[advection-impl]``: one 5.625° fp32 step of the flagship built under
    ``pallas`` and ``auto_train`` bitwise ``auto``'s with its launches, and
    under ``gather`` (taps index-clamped, plain torch) finite with no
    interpolation kernel launched, held against the plain version on each
    layer's recorded inputs where every tap of a position is inside the
    field;
12. the port's interpolation microbenchmark (``[bench-interp]``,
    ``python3 -m paradis_torch.tools.bench_interp``), all fifteen variants.

A ``[time]`` line after each phase gives the seconds since the start.
The last lines are the card line, one JSON object with a record per kernel
(the bilinear route's timed cases too, their launches from
``[bilinear-paths]``), and ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository beside it, the script fails before
printing any result.
"""

from __future__ import annotations

import atexit
import contextlib
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

from paradis_torch.tools.flagship import dims as flagship_dims
from paradis_torch.tools.flagship import flagship, train_batch
from paradis_torch.tools.profile_step import device_profile as profile_steps
# the card's peaks (H100 SXM: HBM3, float32 outside the tensor cores, dense
# bfloat16 on them) and the interpolation kernels' bounds
from paradis_torch.tools.roofline import BF16_FLOPS as PEAK_BF16_FLOPS
from paradis_torch.tools.roofline import FP32_FLOPS as PEAK_FP32_FLOPS
from paradis_torch.tools.roofline import HBM_BW as PEAK_BYTES_PER_S
from paradis_torch.tools.roofline import bound, bound_bwd

STEPS = 40                 # the 10-day forecast protocol: 40 × 6 h
PROFILE_STEPS = 3          # rollout steps traced by torch.profiler
NLAT, NLON = 32, 64        # 5.625°
SPIN_CYCLES_PER_S = 2.0e9   # torch.cuda._sleep cycles a second, at or above the SM clock
MAX_QUEUE_S = 0.25          # the longest spin time_ms queues its calls behind
# device ms a step that this script measured while the banded kernels staged
# their own bands (H100 80GB HBM3, 700 W; PERF.md §5)
EARLIER_DEVICE_MS = {"forecast float32": 16.84, "forecast bfloat16": 15.95,
                     "forecast float32 128x256": 243.01, "forecast bfloat16 128x256": 215.48,
                     "train bfloat16": 73.24, "train float32": 91.37,
                     "train bfloat16 128x256": 922.76, "train float32 128x256": 1261.51,
                     "train-chunk bfloat16 32x64": 74.74,
                     "train-chunk bfloat16 128x256": 906.53}
KERNEL_SOURCE = "paradis_torch/csrc/interp_fwd.cu"
REPLACES = "paradis_tpu/ops/interp_pallas.py:172"
BWD_SOURCE = "paradis_torch/csrc/interp_bwd.cu"
BWD_REPLACES = "paradis_tpu/ops/interp_pallas.py:195"
BAND_SOURCE = "paradis_torch/csrc/interp_band_fwd.cu"
BAND_REPLACES = "paradis_tpu/ops/interp_pallas.py:501"
BAND_BWD_SOURCE = "paradis_torch/csrc/interp_band_bwd.cu"
BAND_BWD_REPLACES = "paradis_tpu/ops/interp_pallas.py:512"
CHUNK_SOURCE = "paradis_torch/csrc/interp_chunk_fwd.cu"
CHUNK_REPLACES = "paradis_tpu/ops/interp_pallas.py:237"
CHUNK_BWD_SOURCE = "paradis_torch/csrc/interp_chunk_bwd.cu"
CHUNK_BWD_REPLACES = "paradis_tpu/ops/interp_pallas.py:254"
BILINEAR_SOURCE = "paradis_torch/csrc/interp_bilinear.cuh"  # every entry point's bilinear route
GEN_SOURCE = "paradis_torch/csrc/interp_gen.cu"
GEN_REPLACES = "scripts/bench_interp.py:107"
BWD_GEN_REPLACES = "scripts/bench_interp.py:221"
MM_SOURCE = "paradis_torch/csrc/interp_mm.cu"
MM_REPLACES = "scripts/bench_interp.py:138"
MMT_REPLACES = "scripts/bench_interp.py:176"
BWD_MM_REPLACES = "scripts/bench_interp.py:248"
CHUNK_RW = 8               # PARADIS_INTERP_CHUNK of the 5.625° chunked runs
HR_CHUNK_RW = 32           # and of the 1.40625° ones
BILINEAR_STEPS = 4         # the steps of run_bilinear_paths' rollouts
TRAIN_STEPS = 6            # train steps on one batch (the first is the warm-up)
TRAIN_PROFILE_STEPS = 2    # train steps traced by torch.profiler
# WSD with a short warmup, so the few steps run at the configured rate
TRAIN_OVERRIDES = ["training.scheduler.wsd.warmup=3"]
HR = (128, 256)            # 1.40625°
BAND_RAD = 0.3             # compute.interp_band_rad of the 1.40625° runs
HR_OVERRIDES = [f"compute.interp_band_rad={BAND_RAD}"]
# the 1.40625° train configuration: banded interpolation and full
# recomputation of each physics layer in the backward
HR_TRAIN_OVERRIDES = TRAIN_OVERRIDES + HR_OVERRIDES + ["compute.gradient_checkpointing=true"]
HR_TRAIN_STEPS = 4         # train steps at 1.40625°
# of which the first ones each timed alone: the first 1.40625° run of the
# process once took its one-time costs (~0.9 s) after its first step
HR_WARM_STEPS = 2
# the chain (short, long, repeats) of tools/bench_forecast's protocol in
# [forecast]: one timed rollout a run (device-bound at 1.40625°: they repeat
# to ~4%)
FORECAST_CHAIN = (0, 1, 1)
# the chunked 1.40625° runs: no band (chunking yields to a band plan), and
# the train steps with full recomputation of each physics layer
HR_CHUNK_OVERRIDES = ["compute.interp_band_rad=0"]
HR_CHUNK_TRAIN_OVERRIDES = (TRAIN_OVERRIDES + HR_CHUNK_OVERRIDES
                            + ["compute.gradient_checkpointing=true"])
# |kernel - plain| limits, elementwise, abs + rel·|plain|: float32 sums the
# same products in another FMA order (under the cancellation of the bicubic
# lobes, ~5e-6 for fields of unit spread); a bfloat16 result is that float32
# sum rounded, so it may also land on the neighbouring bf16 value, one ulp
# ≤ 2^-7 of its magnitude.
KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 1e-5 + 2.0 ** -7)}
# first rollout step, kernel path vs plain path, max |diff| / max |plain|:
# the per-element differences above, carried through 8 layers and the
# output projection.  bf16 rounds every activation (2^-8 relative), so one
# interpolated value landing on the neighbouring bf16 value spreads; the
# measured bf16 ratio is 0.015 at the flagship seed, and the limit is about
# twice that.
STEP_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
# backward kernel vs plain backward, elementwise |diff| <= abs + rel·|plain|,
# for a field and cotangent of unit spread.  d_py and d_px: float32 in both
# dtypes, the same sums of 16 products (Σ|terms| up to ~30 at |g|, |f| ~ 5) in
# another FMA order; measured ≤ 1.3e-5 on values up to 23.  d_field: each cell
# sums the contributions of the up to ~16 positions that tap it, the kernels
# with float32 atomics (shared-memory ones in the unbanded and row-chunked
# backward) in an order that changes from run to run (reruns differ by
# ~1e-6), the plain version with scatter_add; a bf16 d_field is
# that sum rounded, so it may land on the neighbouring bf16 value (≤ 2^-7 of
# its magnitude), as in KERNEL_TOL.
BWD_TOL = {
    "float32": {"d_field": (2e-5, 1e-5), "d_py": (3e-5, 1e-5), "d_px": (3e-5, 1e-5)},
    "bfloat16": {"d_field": (2e-5, 1e-5 + 2.0 ** -7), "d_py": (3e-5, 1e-5),
                 "d_px": (3e-5, 1e-5)},
}
# first train step, parameter gradients through the kernels vs through the
# plain interpolation, max |diff| / max |grad| over the whole gradient: the
# per-element differences above (d_field in a run-to-run order), carried
# back through 8 layers.  In bf16 every activation and its cotangent rounds
# (2^-8 relative), so one d_field value on the neighbouring bf16 value
# spreads.  Measured 2.4e-5 (fp32) and 0.020 (bf16) at the flagship seed;
# the limits are about 4× and 3× that.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -4}
# the same at 1.40625°: the float32 gap is 2.1e-4 here (4.5e-4 on the batch
# of paradis_torch/tools/grad_gap.py), the same to three digits with the
# band off (the unbanded kernels) and with checkpointing off, while the clamp
# binds nowhere (largest row displacement 8.7 px of 12.2) and two runs
# through the kernels differ by ≤ 2.1e-7; so it is the plain path's other
# float32 order, magnified where a pixel is 4× finer and a parameter's
# gradient sums 16× the positions.  The limit is about 5× this batch's gap;
# bf16 as above (measured 0.006).
HR_GRAD_TOL = {"float32": 1e-3, "bfloat16": 2.0 ** -4}
# weight-generation kernel vs plain version, elementwise |diff|: both add the
# same ≤ 4 tap weights (and derivatives) per axis in the same order, but the
# cubic polynomials round differently (FMA on the card) in intermediates of
# magnitude up to 6 (8a, −4a), an ulp of 4.8e-7 each; measured 2.1e-6 (K)
# and 2.6e-6 (K and K′) on sums of magnitude ≤ 2.5.
GEN_TOL = 5e-6
# contraction kernels vs plain versions, max |diff| / max |plain| of each
# output: the same float32 products of identically rounded operands, summed
# in other orders (a kernel over (column, row) pairs, torch's matmul per row
# and then over rows).  For unit-spread operands mm's 2,448 terms give
# outputs up to ~270 with order errors of ~1e-4: measured ≤ 8.8e-7 (mm) and
# 8.9e-7 (bwd_mm's d_field) at the microbenchmark's shapes on an H100.
MM_TOL = 2e-5
# channel and position blocks (vb, pb) that mm's bitwise check adds to the
# variants': the variants' own, and one that divides neither V nor P
MM_BLOCKS = ((8, 1024), (32, 256), (128, 128), (5, 300))
# the AMSE train cell: the 1.40625° bf16 train configuration with the
# spectral loss in place of the reversed Huber
AMSE_OVERRIDES = HR_TRAIN_OVERRIDES + ["training.loss_function.type=amse"]
SHT_SHAPE = (1, 128, 256, 97)  # one 1.40625° output of the flagship
# the card's SHT analysis vs a float64 CPU analysis, max |diff| / max
# |coefficient|: the float32 rounding of the FFT and of the Legendre
# product's sums (≤ 1.8e-7 against the JAX package on the CPU)
SHT_TOL = 1e-5
CKPT_STEPS = 4                 # uninterrupted train steps; the save after half
# where the two uninterrupted runs agree bitwise, the limit on the resumed
# run's distance from them, as a share of the largest loss / parameter
CKPT_FLOOR = 1e-6

# the data pipeline and the host loop ([data], [train-loop])
DATA_TIMES = 20                # six-hourly times of the synthetic stores
WB2_BLOSC = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}  # a WB2 download's codec
DATA_SAMPLES = 5               # samples assembled for the median assembly time
H2D_REPEATS = 5                # host → device copies of one batch, each way
LOOP_DATES = ["training.dataset.start_date=2000-01-01", "training.dataset.end_date=2000-01-03",
              "training.validation_dataset.start_date=2000-01-04",
              "training.validation_dataset.end_date=2000-01-05",
              "training.validation_dataset.validation_batches=1",
              "training.progress_bar=false"]
LOOP_STEPS = 10                # optimizer steps of the 1.40625° loop
LOOP_EVERY = 4                 # its validation and step-checkpoint cadence
LOOP_PROFILE = (2, 2)          # its profiler window: started at step 2, steps 3-4 traced
LOOP_RESUME_STEPS = 2          # steps of the resumed run
SYNC_STEPS = 8                 # steps of the sync_every_n_steps=4 run
LOOP_LR_STEPS = 10             # steps of the 5.625° loop
LOOP_TURN_STEPS = 5            # steps a turn of the 5.625° step fed in turns (the first untimed)
LOOP_MODES = ("loader", "cached", "capped")
LOOP_ROUNDS = 2                # rounds of one turn a mode, each round's order rotated

# forecast I/O ([forecast-io]): python -m paradis_torch.cli.forecast from a
# store on disk, at each grid: the raw store's six-hourly times (n_time_inputs
# + prediction_shift + 40 past the first init, and one sampling interval more
# for a second init), the CLI's end date, its init times, and its overrides
FIO_START = "2000-01-01T06"    # the first init: sample 0's last input time
FIO_INTERVAL = "36h"           # --sampling-interval
FIO_GRIDS = {(NLAT, NLON): (48, "2000-01-03", 2, []),
             HR: (42, "2000-01-01", 1, HR_OVERRIDES)}
FIO_WRITE_EVERY = 10           # --write-every-n
FIO_VARIABLES = [("geopotential", 500), ("temperature", 850)]
FIO_LEADS = [24, 72, 120]      # hours scored by evaluate_store
# BitRound(16) keeps 16 of float32's 23 mantissa bits: a stored value is
# within half a step, 2^-17 of its magnitude, of what was written
BITROUND_STEP = 2.0 ** -16
# [export]: the loaded rollout's gap to the in-process one, as a share of the
# largest |output| (the rollout tolerance of tests/test_export.py:213)
EXPORT_TOL = 1e-5
# [export]'s 1.40625° forward program: steps of its step loop and in-process rollout
EXPORT_HR_STEPS = 10
# [multi-gpu]: train steps of the data-parallel runs, and the FSDP run's
# steps before its checkpoint (as many after the resume)
MG_STEPS = 4
MG_FSDP_K = 2
# each step's logged loss, relative: 2 gloo ranks (batch 1 each) against 1
# process (batch 2), FSDP against replicated, a resumed run against the
# uninterrupted one.  Measured (H100 80GB HBM3, 700.00 W; 4 steps): fp32
# within 1.5e-6 (float32 sums in another order), bf16 within 1.2e-5, FSDP
# 2.1e-5; and one bf16 process run twice differs by 8.6e-6 at step 4 (the
# backward's float atomics), so the gaps are that noise; the limit is 5x
# the largest
MG_LOSS_RTOL = 1e-4
# [spatial]: forecast steps of the 1.40625° lat_devices=2 run, and its
# store's gap to [forecast-io]'s one-process store beyond a BitRound(16)
# step, as a share of each variable's largest value (float32 sums in
# another order over 3 steps of 8 layers; the CPU test measures 3.1e-8)
SPATIAL_FC_STEPS = 3
SPATIAL_FC_TOL = 1e-4
# the file [export]'s preparation writes when [forecast-io]'s store and weights
# of a grid are ready (the grid's latitudes in the name)
FIO_READY = "fio_ready{}.json"
DATA_READY = "data_ready.json"  # and when [data]'s are
EXPORT_READY = "export_prep.json"  # and when [export]'s artifacts are written
TOOLS_READY = "tools_ready.json"  # and when its host tools have run (host_tools)
PIPELINE_SAMPLES = 8            # samples bench_pipeline times on [data]'s stores
# the smoke's runs of the tools the JAX package has as scripts: profile_live
# on [data]'s 5.625° store, ns_convergence and lq_convergence on their toy
PROFILE_LIVE_ARGS = ["--steps", "10", "--batch", "1", "--sync", "4"]
CONVERGENCE_STEPS = 4
# the files of a one-epoch cli.train run (the JAX checkpoint layout)
MG_RUN_FILES = ["checkpoints/best/best/params.pt", "checkpoints/best/best/state.pt",
                "checkpoints/best/metric.json", "checkpoints/epochs/0001/params.pt",
                "checkpoints/epochs/0001/state.pt", "checkpoints/last.json", "config.yaml",
                "git_info.json", "metrics.csv"]
# the microbenchmark's repeats here (its default is 5), and the model benchmark's (3;
# one round of turns pays for [spatial], ~26 s a round)
BENCH_INTERP_REPEATS = 2
BENCH_MODEL_REPEATS = 1


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events).

    The timed calls are queued behind a spin kernel that lasts as long as the
    host takes to enqueue them (measured on a few calls, at most
    ``MAX_QUEUE_S``), so that a call which the host enqueues slower than the
    card runs it (a kernel of ~30 us behind a Python wrapper) is timed on the
    card, not at the host's rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    sample = min(iters, 10)
    t0 = time.perf_counter()
    for _ in range(sample):
        fn()
    enqueue_s = (time.perf_counter() - t0) / sample
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * min(1.5 * enqueue_s * iters + 1e-3, MAX_QUEUE_S)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def interp_inputs(B, R, C, V, H, W, dtype, seed):
    """Field and departure positions as the model makes them: arrival point
    plus pad plus a displacement of ~1.5 px, and 5% anywhere up to 3 px
    outside the field (taps there are dropped)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    pad_y, pad_x = (R - H) // 2, (C - W) // 2
    field = torch.randn(B, R, C, V, generator=g, device=dev).to(dtype)
    ay = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1, 1) + pad_y
    ax = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W, 1) + pad_x
    py = ay + 1.5 * torch.randn(B, H, W, V, generator=g, device=dev)
    px = ax + 1.5 * torch.randn(B, H, W, V, generator=g, device=dev)
    wild = torch.rand(B, H, W, V, generator=g, device=dev) < 0.05
    py = torch.where(wild, torch.rand(B, H, W, V, generator=g, device=dev) * (R + 5) - 3, py)
    px = torch.where(wild, torch.rand(B, H, W, V, generator=g, device=dev) * (C + 5) - 3, px)
    return field, py.contiguous(), px.contiguous()


def _iters(py, kernel: int, plain: int) -> tuple[int, int]:
    """Timing repetitions: fewer at the 1.40625° shapes (25 M outputs), where
    the plain versions take tens to hundreds of ms a call."""
    return (kernel, plain) if py.numel() < 5_000_000 else (max(kernel // 5, 20), 3)


def band_inputs(field, py, bound: float, mode: str):
    """Positions clamped to ±``bound`` px of their padded arrival row, as
    ``interpolate`` clamps, and the band plan for them (None where the gate
    is off)."""
    import torch

    from paradis_torch.ops.interp_band import band_spec

    _, R, _, _ = field.shape
    _, H, W, _ = py.shape
    pad = (R - H) // 2
    arr = torch.arange(H, dtype=torch.float32, device=py.device).view(1, H, 1, 1) + pad
    py = torch.clamp(py, arr - bound, arr + bound).contiguous()
    return py, band_spec(H, W, R, mode, bound)


def grid_sample_args(field, py, px, dtype):
    """``F.grid_sample``'s arguments for the same function: the field as
    [B·V, 1, R, C] and normalised align-corners coordinates."""
    import torch

    B, R, C, V = field.shape
    _, H, W, _ = py.shape
    img = field.permute(0, 3, 1, 2).reshape(B * V, 1, R, C).contiguous()
    gx = (px / (C - 1) * 2 - 1).permute(0, 3, 1, 2).reshape(B * V, 1, H * W)
    gy = (py / (R - 1) * 2 - 1).permute(0, 3, 1, 2).reshape(B * V, 1, H * W)
    return img, torch.stack([gx, gy], dim=-1).to(dtype).contiguous()


def check_kernel(mode: str, dtype_name: str, shape, timed: bool,
                 band_px: float | None = None, chunk_rw: int = 0,
                 depart_px: float | None = None) -> dict:
    """The forward kernel against its plain version; with ``band_px``, the
    row-banded kernel on positions clamped to it, held against the banded
    plain version and against the unbanded kernel on the same positions;
    with ``chunk_rw``, the row-chunked kernel (on positions clamped to
    ``depart_px`` when given), held against its plain version and, bitwise,
    against the unbanded kernel; else the unbanded kernel, held against its
    plain version and, bitwise, against the row-chunked kernel at
    ``CHUNK_RW``, with the route it takes.  The banded and chunked kernels
    are held bitwise against the unbanded one.  With ``timed``, the kernel's time
    beside the plain version's, ``F.grid_sample``'s, the unbanded kernel's
    (or, for the unbanded kernel, the row-chunked kernel's; and, for a
    chunked case where the band gate passes at ``depart_px``, the banded
    kernel's) and the bound."""
    import torch
    import torch.nn.functional as F

    from paradis_torch.ops.interp import interp_plain
    from paradis_torch.ops.interp_band import interp_band_plain
    from paradis_torch.ops.interp_chunk import interp_chunk_plain
    from paradis_torch.ops.interp_cuda import (interp_band_fwd_cuda, interp_chunk_fwd_cuda,
                                               interp_fwd_cuda, interp_fwd_route)

    dtype = getattr(torch, dtype_name)
    B, R, C, V, H, W = shape
    field, py, px = interp_inputs(B, R, C, V, H, W, dtype, seed=len(mode) + V)
    spec = None
    if band_px is not None:
        py, spec = band_inputs(field, py, band_px, mode)
        kernel = lambda: interp_band_fwd_cuda(field, py, px, spec, mode)  # noqa: E731
        plain = lambda: interp_band_plain(field, py, px, spec, mode)  # noqa: E731
    elif chunk_rw:
        if depart_px is not None:
            py, spec = band_inputs(field, py, depart_px, mode)
        kernel = lambda: interp_chunk_fwd_cuda(field, py, px, chunk_rw, mode)  # noqa: E731
        plain = lambda: interp_chunk_plain(field, py, px, chunk_rw, mode)  # noqa: E731
    else:
        kernel = lambda: interp_fwd_cuda(field, py, px, mode)  # noqa: E731
        plain = lambda: interp_plain(field, py, px, mode)  # noqa: E731
    out = kernel()
    refs = {"plain": plain()}
    if band_px is not None or chunk_rw:
        refs["unbanded"] = interp_fwd_cuda(field, py, px, mode)
    else:
        refs["chunk"] = interp_chunk_fwd_cuda(field, py, px, CHUNK_RW, mode)
    torch.cuda.synchronize()
    atol, rtol = KERNEL_TOL[dtype_name]
    res = {"mode": mode, "dtype": dtype_name, "shape": [B, R, C, V, H, W],
           "ok": out.dtype == dtype and bool(torch.isfinite(out).all())}
    if band_px is not None:
        res.update(band_px=band_px, band_plan=list(spec))
    if chunk_rw:
        res.update(chunk_rw=chunk_rw, depart_px=depart_px)
    if band_px is not None or chunk_rw:
        # the banded and chunked entry points: the bilinear route, or the
        # bicubic window kernel
        res.update(route="bilinear" if mode == "bilinear" else "window",
                   bitwise_equal_unbanded=bool(torch.equal(out, refs["unbanded"])))
        res["ok"] = res["ok"] and res["bitwise_equal_unbanded"]
    else:
        res.update(route=interp_fwd_route(field, mode),
                   bitwise_equal_chunk=bool(torch.equal(out, refs["chunk"])))
        res["ok"] = res["ok"] and res["bitwise_equal_chunk"]
    for name, ref in refs.items():
        diff = (out.float() - ref.float()).abs()
        limit = atol + rtol * ref.float().abs()
        key = "" if name == "plain" else f"{name}_"
        res[f"{key}max_abs_err"] = float(diff.max())
        res[f"{key}worst_err_over_limit"] = float((diff / limit).max())
        res["ok"] = res["ok"] and bool((diff <= limit).all())
    if timed:
        k_iters, p_iters = _iters(py, 200, 20)
        res["ms"] = time_ms(kernel, iters=k_iters)
        if band_px is not None or chunk_rw:
            res["unbanded_ms"] = time_ms(lambda: interp_fwd_cuda(field, py, px, mode),
                                         iters=k_iters)
        else:
            res["chunk_ms"] = time_ms(
                lambda: interp_chunk_fwd_cuda(field, py, px, CHUNK_RW, mode), iters=k_iters)
        if chunk_rw and spec is not None:
            res["banded_ms"] = time_ms(lambda: interp_band_fwd_cuda(field, py, px, spec, mode),
                                       iters=k_iters)
        res["plain_ms"] = time_ms(plain, iters=p_iters, warmup=1 if p_iters <= 3 else 5)
        img, grid = grid_sample_args(field, py, px, dtype)

        def lib():
            return F.grid_sample(img, grid, mode=mode, padding_mode="zeros",
                                 align_corners=True)

        res["library_ms"] = time_ms(lib, iters=max(k_iters // 4, 10))
        if dtype_name == "float32":
            lib_out = lib().reshape(B, V, H, W).permute(0, 2, 3, 1)
            res["library_max_abs_diff_vs_plain"] = float((lib_out - refs["plain"]).abs().max())
        res["bound_ms"], res["bound_by"] = bound(field, py, mode)
    return res


def run_bilinear_paths() -> dict:
    """The model's bilinear paths (``model.adv_interpolation=bilinear``),
    through the tools a user times them with, each once (a
    ``BILINEAR_STEPS``-step ``bench_forecast`` rollout in float32, a
    ``bench_highres`` step in bfloat16, and in float32 with
    ``compute.use_amp=false``): unbanded at 5.625°, banded at 1.40625° (the
    tools' ``compute.interp_band_rad=0.3``), and row-chunked at both
    (``compute.interp_band_rad=0``, ``PARADIS_INTERP_CHUNK`` ``CHUNK_RW`` /
    ``HR_CHUNK_RW``).  ``{label: {"launches": the interpolation kernels'
    launches a rollout or step, "expected": ..., "ok": ...}}``; a run is ok
    where it launched its entry points only, as many times as its path
    takes them (8 layers), and its output or losses are finite."""
    from paradis_torch.tools import bench_forecast, bench_highres

    chain = ["--chain-short", "0", "--chain-long", "1", "--repeats", "1",
             "--override", "model.adv_interpolation=bilinear"]
    lr = ["--nlat", str(NLAT), "--nlon", str(NLON)]  # bench_highres's; bench_forecast's default
    hr = ["--nlat", str(HR[0]), "--nlon", str(HR[1])]
    unbanded = ["--override", "compute.interp_band_rad=0"]
    fp32 = ["--override", "compute.use_amp=false"]
    fc = 8 * BILINEAR_STEPS
    runs = {  # label: tool, arguments, chunk rows, the launches expected
        "forecast float32 5.625": (bench_forecast, [], 0, {"interp_fwd": fc}),
        "train bfloat16 5.625": (bench_highres, lr + unbanded, 0,
                                 {"interp_fwd": 16, "interp_bwd": 8}),
        "train float32 5.625": (bench_highres, lr + unbanded + fp32, 0,
                                {"interp_fwd": 16, "interp_bwd": 8}),
        "forecast float32 1.40625": (bench_forecast, hr, 0, {"interp_band_fwd": fc}),
        "train bfloat16 1.40625": (bench_highres, hr, 0,
                                   {"interp_band_fwd": 16, "interp_band_bwd": 8}),
        "train float32 1.40625": (bench_highres, hr + fp32, 0,
                                  {"interp_band_fwd": 16, "interp_band_bwd": 8}),
        "forecast-chunk float32 5.625": (bench_forecast, [], CHUNK_RW,
                                         {"interp_chunk_fwd": fc}),
        "train-chunk bfloat16 5.625": (bench_highres, lr + unbanded, CHUNK_RW,
                                       {"interp_chunk_fwd": 16, "interp_chunk_bwd": 8}),
        "forecast-chunk float32 1.40625": (bench_forecast, hr + unbanded, HR_CHUNK_RW,
                                           {"interp_chunk_fwd": fc}),
        "train-chunk bfloat16 1.40625": (bench_highres, hr + unbanded, HR_CHUNK_RW,
                                         {"interp_chunk_fwd": 16, "interp_chunk_bwd": 8}),
    }
    out = {}
    for label, (tool, argv, rw, expected) in runs.items():
        steps = ["--steps", str(BILINEAR_STEPS)] if tool is bench_forecast else []
        with interp_chunk_env(rw):
            res = tool.main(argv + steps + chain)
        if tool is bench_forecast:
            launches, finite = res["launches_per_rollout"], res["finite"]
        else:
            launches = res["launches_per_step"]
            finite = all(math.isfinite(v) for v in res["losses"])
        out[label] = {"launches": launches, "expected": expected, "finite": finite,
                      "ok": launches == expected and finite}
    return out


def bilinear_records(checks, bwd_checks, band_checks, band_bwd_checks, chunk_checks,
                     chunk_bwd_checks, paths: dict) -> list:
    """The kernels line's records of the bilinear route
    (``csrc/interp_bilinear.cuh``), one for each timed bilinear case of the
    entry points that the bicubic records cover, its launches counted in the
    bilinear run of the path that takes it (``run_bilinear_paths``, a
    rollout or a train step): the float32 forwards in a rollout, the bfloat16
    ones and the backwards in a train step."""
    def grid(c):
        return "1.40625" if c["shape"][4] == HR[0] else "5.625"

    def run(c, kind):
        return paths[f"{kind} {c['dtype']} {grid(c)}"]["launches"]

    records = []
    for name, source, replaces, found, launches in (
            ("interp_fwd", KERNEL_SOURCE, REPLACES, checks,
             lambda c: run(c, "forecast" if c["dtype"] == "float32" else "train")),
            ("interp_bwd", BWD_SOURCE, BWD_REPLACES, bwd_checks, lambda c: run(c, "train")),
            ("interp_band_fwd", BAND_SOURCE, BAND_REPLACES, band_checks,
             lambda c: run(c, "forecast" if c["dtype"] == "float32" else "train")),
            ("interp_band_bwd", BAND_BWD_SOURCE, BAND_BWD_REPLACES, band_bwd_checks,
             lambda c: run(c, "train")),
            ("interp_chunk_fwd", CHUNK_SOURCE, CHUNK_REPLACES, chunk_checks,
             lambda c: run(c, "forecast-chunk" if c["dtype"] == "float32" else "train-chunk")),
            ("interp_chunk_bwd", CHUNK_BWD_SOURCE, CHUNK_BWD_REPLACES,
             [c for c in chunk_bwd_checks if c["dtype"] == "bfloat16"],
             lambda c: run(c, "train-chunk"))):
        for c in found:
            if c["mode"] != "bilinear" or "ms" not in c:
                continue
            tag = f",rw{c['chunk_rw']},{c['shape'][4]}x{c['shape'][5]}" if "chunk_rw" in c else ""
            rec = {"name": f"{name}[bilinear,{c['dtype']}{tag}]", "route": "cuda",
                   "source": BILINEAR_SOURCE, "entry": source, "replaces": replaces,
                   "launches": launches(c).get(name, 0), "max_abs_err": c["max_abs_err"],
                   "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                   "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
            for extra in ("unbanded_ms", "banded_ms", "chunk_ms"):
                if extra in c:
                    rec[extra] = c[extra]
            records.append(rec)
    return records


def sorted_quantiles(values, qs) -> list[float]:
    """Quantiles of a 1-D tensor by sorting it (no size limit)."""
    v = values.sort().values
    return [float(v[min(int(q * (v.numel() - 1) + 0.5), v.numel() - 1)]) for q in qs]


def check_rollout_kernel(dtype_name: str, captured: list) -> dict:
    """The unbanded forward kernel on the inputs of the first rollout step's
    launches (``recording_fwd``; the model's weights are seeded random, the
    repo has no trained checkpoint): each launch held against the plain
    version within ``KERNEL_TOL`` and, bitwise, against the row-chunked kernel
    at ``CHUNK_RW``.  The departure rows' and columns' distance from their
    padded arrival point (p50, p99, max) and the share of taps outside the
    field.  Times per launch, over the step's launches in turn (their inputs
    together exceed the L2 cache): the kernel, the row-chunked kernel,
    ``F.grid_sample``, the plain version, and the mean bound."""
    import torch
    import torch.nn.functional as F

    from paradis_torch.ops.interp import interp_plain, tap_weights
    from paradis_torch.ops.interp_cuda import (interp_chunk_fwd_cuda, interp_fwd_cuda,
                                               interp_fwd_route)

    captured = [(f.cuda(), y.cuda(), x.cuda(), m) for f, y, x, m in captured]
    atol, rtol = KERNEL_TOL[dtype_name]
    res = {"dtype": dtype_name, "launches": len(captured), "shape": None,
           "weights": "seeded random (no trained checkpoint)", "ok": len(captured) > 0,
           "max_abs_err": 0.0, "worst_err_over_limit": 0.0, "bitwise_equal_chunk": True}
    dys, dxs, taps_in, taps_all, routes = [], [], 0, 0, set()
    for field, py, px, mode in captured:
        B, R, C, V = field.shape
        _, H, W, _ = py.shape
        res["shape"], res["mode"] = [B, R, C, V, H, W], mode
        routes.add(interp_fwd_route(field, mode))
        out = interp_fwd_cuda(field, py, px, mode)
        ref = interp_plain(field, py, px, mode)
        chunk = interp_chunk_fwd_cuda(field, py, px, CHUNK_RW, mode)
        diff = (out.float() - ref.float()).abs()
        limit = atol + rtol * ref.float().abs()
        res["max_abs_err"] = max(res["max_abs_err"], float(diff.max()))
        res["worst_err_over_limit"] = max(res["worst_err_over_limit"],
                                          float((diff / limit).max()))
        res["bitwise_equal_chunk"] = res["bitwise_equal_chunk"] and bool(torch.equal(out, chunk))
        res["ok"] = (res["ok"] and out.dtype == field.dtype and bool(torch.isfinite(out).all())
                     and bool((diff <= limit).all()))
        pad_y, pad_x = (R - H) // 2, (C - W) // 2
        ay = torch.arange(H, device=py.device, dtype=torch.float32).view(1, H, 1, 1) + pad_y
        ax = torch.arange(W, device=px.device, dtype=torch.float32).view(1, 1, W, 1) + pad_x
        finite = torch.isfinite(py) & torch.isfinite(px)
        dys.append((py - ay).abs()[finite])
        dxs.append((px - ax).abs()[finite])
        # taps of each position inside the field: rows in range × columns in range
        n_in = 1
        for pos, size in ((py, R), (px, C)):
            i0, offsets, _ = tap_weights(pos, mode)
            n_in = n_in * sum(((i0 + o >= 0) & (i0 + o <= size - 1)).float() for o in offsets)
        taps_in += float((n_in * finite).sum())
        taps_all += py.numel() * len(offsets) ** 2
    res["ok"] = res["ok"] and res["bitwise_equal_chunk"]
    res["routes"] = sorted(routes)
    qs = (0.5, 0.99, 1.0)
    res["row_displacement_px_p50_p99_max"] = sorted_quantiles(torch.cat(dys), qs)
    res["col_displacement_px_p50_p99_max"] = sorted_quantiles(torch.cat(dxs), qs)
    res["taps_outside_share"] = 1.0 - taps_in / taps_all
    n = len(captured)
    res["ms"] = time_ms(lambda: [interp_fwd_cuda(*c) for c in captured], iters=50) / n
    res["chunk_ms"] = time_ms(
        lambda: [interp_chunk_fwd_cuda(f, y, x, CHUNK_RW, m) for f, y, x, m in captured],
        iters=50) / n
    lib_args = [(*grid_sample_args(f, y, x, f.dtype), m) for f, y, x, m in captured]
    res["library_ms"] = time_ms(
        lambda: [F.grid_sample(img, grid, mode=m, padding_mode="zeros", align_corners=True)
                 for img, grid, m in lib_args], iters=20) / n
    res["plain_ms"] = time_ms(lambda: [interp_plain(*c) for c in captured], iters=3,
                              warmup=1) / n
    bounds = [bound(f, y, m) for f, y, _, m in captured]
    res["bound_ms"] = sum(b for b, _ in bounds) / n
    res["bound_by"] = bounds[0][1]
    return res


def check_bwd_kernel(mode: str, dtype_name: str, shape, timed: bool,
                     integer: bool = False, band_px: float | None = None,
                     chunk_rw: int = 0, depart_px: float | None = None) -> dict:
    """The backward kernel against the plain backward; with ``band_px``, the
    row-banded backward on positions clamped to it, held against the banded
    plain backward and against the unbanded kernel on the same positions;
    with ``chunk_rw``, the row-chunked backward (on positions clamped to
    ``depart_px`` when given), held against its plain version and the
    unbanded kernel (d_py and d_px bitwise, as for the banded backward); else
    the unbanded backward, held against its plain version and the row-chunked
    backward at ``CHUNK_RW`` (d_py and d_px bitwise).  With ``timed``, its time beside the plain
    backward's, ``F.grid_sample``'s backward, the unbanded kernel's (or, for
    the unbanded kernel, the row-chunked kernel's; and the banded kernel's
    where the band gate passes at ``depart_px``) and the bound."""
    import torch
    import torch.nn.functional as F

    from paradis_torch.ops.interp import interp_bwd_plain
    from paradis_torch.ops.interp_band import interp_band_bwd_plain
    from paradis_torch.ops.interp_chunk import interp_chunk_bwd_plain
    from paradis_torch.ops.interp_cuda import (interp_band_bwd_cuda, interp_bwd_cuda,
                                               interp_chunk_bwd_cuda)

    dtype = getattr(torch, dtype_name)
    B, R, C, V, H, W = shape
    field, py, px = interp_inputs(B, R, C, V, H, W, dtype, seed=len(mode) + V + 1)
    if integer:
        py, px = py.round(), px.round()
    gen = torch.Generator(device="cuda").manual_seed(V)
    g = torch.randn(py.shape, generator=gen, device="cuda").to(dtype)
    spec = None
    if band_px is not None:
        py, spec = band_inputs(field, py, band_px, mode)
        kernel = lambda: interp_band_bwd_cuda(field, py, px, g, spec, mode)  # noqa: E731
        plain = lambda: interp_band_bwd_plain(field, py, px, g, spec, mode)  # noqa: E731
    elif chunk_rw:
        if depart_px is not None:
            py, spec = band_inputs(field, py, depart_px, mode)
        kernel = lambda: interp_chunk_bwd_cuda(field, py, px, g, chunk_rw, mode)  # noqa: E731
        plain = lambda: interp_chunk_bwd_plain(field, py, px, g, chunk_rw, mode)  # noqa: E731
    else:
        kernel = lambda: interp_bwd_cuda(field, py, px, g, mode)  # noqa: E731
        plain = lambda: interp_bwd_plain(field, py, px, g, mode)  # noqa: E731
    out = kernel()
    refs = {"plain": plain()}
    if band_px is not None or chunk_rw:
        refs["unbanded"] = interp_bwd_cuda(field, py, px, g, mode)
    else:
        refs["chunk"] = interp_chunk_bwd_cuda(field, py, px, g, CHUNK_RW, mode)
    torch.cuda.synchronize()
    res = {"mode": mode, "dtype": dtype_name, "shape": [B, R, C, V, H, W],
           "integer_positions": integer, "ok": out[0].dtype == dtype,
           "route": "bilinear" if mode == "bilinear" else "row-slab"}
    if band_px is not None:
        res.update(band_px=band_px, band_plan=list(spec))
    if chunk_rw:
        res.update(chunk_rw=chunk_rw, depart_px=depart_px)
    if band_px is not None or chunk_rw:
        res["bitwise_equal_unbanded_d_pos"] = bool(torch.equal(out[1], refs["unbanded"][1])
                                                   and torch.equal(out[2], refs["unbanded"][2]))
        res["ok"] = res["ok"] and res["bitwise_equal_unbanded_d_pos"]
    else:
        res["bitwise_equal_chunk_d_pos"] = bool(torch.equal(out[1], refs["chunk"][1])
                                                and torch.equal(out[2], refs["chunk"][2]))
        res["ok"] = res["ok"] and res["bitwise_equal_chunk_d_pos"]
    for ref_name, ref in refs.items():
        key = "" if ref_name == "plain" else f"{ref_name}_"
        res[f"{key}max_abs_err"] = res[f"{key}worst_err_over_limit"] = 0.0
        for name, o, r in zip(("d_field", "d_py", "d_px"), out, ref):
            atol, rtol = BWD_TOL[dtype_name][name]
            diff = (o.float() - r.float()).abs()
            limit = atol + rtol * r.float().abs()
            res[f"{key}{name}_max_abs_err"] = float(diff.max())
            res[f"{key}max_abs_err"] = max(res[f"{key}max_abs_err"], float(diff.max()))
            res[f"{key}worst_err_over_limit"] = max(res[f"{key}worst_err_over_limit"],
                                                    float((diff / limit).max()))
            res["ok"] = (res["ok"] and bool((diff <= limit).all())
                         and bool(torch.isfinite(o).all()))
    if integer and mode == "bilinear":
        res["ok"] = res["ok"] and not out[1].any() and not out[2].any()
    if timed:
        k_iters, p_iters = _iters(py, 100, 10)
        res["ms"] = time_ms(kernel, iters=k_iters)
        if band_px is not None or chunk_rw:
            res["unbanded_ms"] = time_ms(lambda: interp_bwd_cuda(field, py, px, g, mode),
                                         iters=k_iters)
        else:
            res["chunk_ms"] = time_ms(
                lambda: interp_chunk_bwd_cuda(field, py, px, g, CHUNK_RW, mode), iters=k_iters)
        if chunk_rw and spec is not None:
            res["banded_ms"] = time_ms(
                lambda: interp_band_bwd_cuda(field, py, px, g, spec, mode), iters=k_iters)
        res["plain_ms"] = time_ms(plain, iters=p_iters, warmup=1 if p_iters <= 3 else 5)
        img, grid = grid_sample_args(field, py, px, dtype)
        img.requires_grad_()
        grid.requires_grad_()
        lib_out = F.grid_sample(img, grid, mode=mode, padding_mode="zeros", align_corners=True)
        g_lib = g.permute(0, 3, 1, 2).reshape(B * V, 1, 1, H * W).contiguous()
        res["library_ms"] = time_ms(
            lambda: torch.autograd.grad(lib_out, (img, grid), g_lib, retain_graph=True),
            iters=max(k_iters // 2, 10))
        res["bound_ms"], res["bound_by"] = bound_bwd(field, py, g, mode)
    return res


def band_taps(py, spec, R: int, mode: str):
    """``(kept, cut)`` of each (position, channel): whether any of its tap
    rows lies in its band (and so in the field), and whether any lies in the
    field but outside its band.  A non-finite row has neither."""
    import torch

    from paradis_torch.ops.interp_band import band_rows_window

    _, H, W, _ = py.shape
    lo, hi = (t.view(1, H, W, 1) for t in band_rows_window(spec, R, H, W, py.device))
    first, n = (-1, 4) if mode == "bicubic" else (0, 2)
    kept = torch.zeros_like(py, dtype=torch.bool)
    cut = torch.zeros_like(kept)
    for k in range(n):
        r = torch.floor(py) + (first + k)
        in_band = (r >= lo) & (r < hi)
        kept |= in_band
        cut |= (r >= 0) & (r <= R - 1) & ~in_band
    return kept, cut


def check_band_outside(mode: str, dtype_name: str, shape, bound: float) -> dict:
    """The row-banded pair on rows that are not clamped: ``band_inputs``'
    rows, 30% of them pushed 5–20 px further out, so that taps leave their
    band (inside the field and beyond it); 1% of the rows NaN, 1% inf, 1% of
    the columns -inf.  Held against the banded plain versions (``KERNEL_TOL``,
    ``BWD_TOL``); against the unbanded kernels, unequal on the items with a
    tap in the field outside its band (``cut``) and bitwise equal elsewhere
    (the forward, d_py and d_px); out, d_py and d_px exactly zero where no
    tap row is kept."""
    import torch

    from paradis_torch.ops.interp_band import interp_band_bwd_plain, interp_band_plain
    from paradis_torch.ops.interp_cuda import (interp_band_bwd_cuda, interp_band_fwd_cuda,
                                               interp_bwd_cuda, interp_fwd_cuda)

    dtype = getattr(torch, dtype_name)
    B, R, C, V, H, W = shape
    field, py, px = interp_inputs(B, R, C, V, H, W, dtype, seed=len(mode) + V + 2)
    py, spec = band_inputs(field, py, bound, mode)
    gen = torch.Generator(device="cuda").manual_seed(V + 3)
    arr = (torch.arange(H, dtype=torch.float32, device="cuda").view(1, H, 1, 1)
           + (R - H) // 2)
    dy = py - arr
    push = torch.rand(py.shape, generator=gen, device="cuda") < 0.3
    far = 5.0 + 15.0 * torch.rand(py.shape, generator=gen, device="cuda")
    py = arr + torch.where(push, dy + torch.sign(dy) * far, dy)
    pick = torch.rand(py.shape, generator=gen, device="cuda")
    py = torch.where(pick < 0.01, float("nan"), py)
    py = torch.where((pick >= 0.01) & (pick < 0.02), float("inf"), py).contiguous()
    px = torch.where((pick >= 0.02) & (pick < 0.03), float("-inf"), px).contiguous()
    g = torch.randn(py.shape, generator=gen, device="cuda").to(dtype)
    out = interp_band_fwd_cuda(field, py, px, spec, mode)
    grads = interp_band_bwd_cuda(field, py, px, g, spec, mode)
    unb_out = interp_fwd_cuda(field, py, px, mode)
    unb = interp_bwd_cuda(field, py, px, g, mode)
    kept, cut = band_taps(py, spec, R, mode)
    no_tap = ~kept | ~torch.isfinite(px)
    res = {"mode": mode, "dtype": dtype_name, "shape": [B, R, C, V, H, W], "band_px": bound,
           "band_plan": list(spec), "share_cut": float(cut.float().mean()),
           "share_no_kept_tap": float(no_tap.float().mean()),
           "share_in_field_none_kept": float((~kept & cut).float().mean()),
           "ok": bool(cut.any()) and bool((~kept & cut).any()) and bool((~cut).any())
           and out.dtype == dtype and grads[0].dtype == dtype}
    for name, o, r, (atol, rtol) in (
            ("out", out, interp_band_plain(field, py, px, spec, mode), KERNEL_TOL[dtype_name]),
            *((n, o, r, BWD_TOL[dtype_name][n]) for n, o, r in zip(
                ("d_field", "d_py", "d_px"), grads,
                interp_band_bwd_plain(field, py, px, g, spec, mode)))):
        diff = (o.float() - r.float()).abs()
        limit = atol + rtol * r.float().abs()
        res[f"{name}_max_abs_err"] = float(diff.max())
        res[f"{name}_worst_err_over_limit"] = float((diff / limit).max())
        res["ok"] = res["ok"] and bool((diff <= limit).all()) and bool(torch.isfinite(o).all())
    res["differs_from_unbanded_where_cut"] = (
        bool((out != unb_out)[cut].any())
        and bool(((grads[1] != unb[1]) | (grads[2] != unb[2]))[cut].any()))
    uncut = ~cut
    res["bitwise_equal_unbanded_where_uncut"] = (
        bool(torch.equal(out[uncut], unb_out[uncut]))
        and bool(torch.equal(grads[1][uncut], unb[1][uncut]))
        and bool(torch.equal(grads[2][uncut], unb[2][uncut])))
    res["zero_where_no_kept_tap"] = not (bool(out[no_tap].any()) or bool(grads[1][no_tap].any())
                                         or bool(grads[2][no_tap].any()))
    res["ok"] = (res["ok"] and res["differs_from_unbanded_where_cut"]
                 and res["bitwise_equal_unbanded_where_uncut"] and res["zero_where_no_kept_tap"])
    return res


def check_train_bwd_kernel(dtype_name: str, captured: list) -> dict:
    """The unbanded backward kernel on the inputs of the first train step's
    launches (``recording_bwd``; the model's weights are seeded random, the
    repo has no trained checkpoint): each launch held against the plain
    backward within ``BWD_TOL`` and, on d_py and d_px bitwise, against the
    row-chunked backward at ``CHUNK_RW``; the departure rows' distance from
    their padded arrival row (p50, p99, max).  Times per launch, over the
    step's launches in turn: the kernel, the row-chunked kernel, the backward
    of ``F.grid_sample``, the plain version, and the mean bound."""
    import torch
    import torch.nn.functional as F

    from paradis_torch.ops.interp import interp_bwd_plain
    from paradis_torch.ops.interp_cuda import interp_bwd_cuda, interp_chunk_bwd_cuda

    captured = [tuple(t.cuda() for t in c[:4]) + (c[4],) for c in captured]
    res = {"dtype": dtype_name, "launches": len(captured), "shape": None,
           "weights": "seeded random (no trained checkpoint)", "ok": len(captured) > 0,
           "max_abs_err": 0.0, "worst_err_over_limit": 0.0, "bitwise_equal_chunk_d_pos": True}
    dys = []
    for field, py, px, g, mode in captured:
        B, R, C, V = field.shape
        _, H, W, _ = py.shape
        res["shape"], res["mode"], res["g_dtype"] = [B, R, C, V, H, W], mode, str(g.dtype)
        out = interp_bwd_cuda(field, py, px, g, mode)
        chunk = interp_chunk_bwd_cuda(field, py, px, g, CHUNK_RW, mode)
        ref = interp_bwd_plain(field, py, px, g, mode)
        res["bitwise_equal_chunk_d_pos"] = (res["bitwise_equal_chunk_d_pos"]
                                            and bool(torch.equal(out[1], chunk[1]))
                                            and bool(torch.equal(out[2], chunk[2])))
        res["ok"] = res["ok"] and out[0].dtype == field.dtype
        for name, o, r in zip(("d_field", "d_py", "d_px"), out, ref):
            atol, rtol = BWD_TOL[dtype_name][name]
            diff = (o.float() - r.float()).abs()
            limit = atol + rtol * r.float().abs()
            res["max_abs_err"] = max(res["max_abs_err"], float(diff.max()))
            res["worst_err_over_limit"] = max(res["worst_err_over_limit"],
                                              float((diff / limit).max()))
            res["ok"] = (res["ok"] and bool((diff <= limit).all())
                         and bool(torch.isfinite(o).all()))
        ay = torch.arange(H, device=py.device, dtype=torch.float32).view(1, H, 1, 1) + (R - H) // 2
        dys.append((py - ay).abs()[torch.isfinite(py)])
    res["ok"] = res["ok"] and res["bitwise_equal_chunk_d_pos"]
    res["row_displacement_px_p50_p99_max"] = sorted_quantiles(torch.cat(dys), (0.5, 0.99, 1.0))
    n = len(captured)
    res["ms"] = time_ms(lambda: [interp_bwd_cuda(*c) for c in captured], iters=20) / n
    res["chunk_ms"] = time_ms(
        lambda: [interp_chunk_bwd_cuda(f, y, x, g, CHUNK_RW, m) for f, y, x, g, m in captured],
        iters=20) / n
    lib = []
    for field, py, px, g, mode in captured:
        B, R, C, V = field.shape
        _, H, W, _ = py.shape
        img, grid = grid_sample_args(field, py, px, field.dtype)
        img.requires_grad_()
        grid.requires_grad_()
        lib_out = F.grid_sample(img, grid, mode=mode, padding_mode="zeros", align_corners=True)
        g_lib = g.permute(0, 3, 1, 2).reshape(B * V, 1, 1, H * W).to(field.dtype).contiguous()
        lib.append((lib_out, img, grid, g_lib))
    res["library_ms"] = time_ms(
        lambda: [torch.autograd.grad(o, (i, gr), gl, retain_graph=True) for o, i, gr, gl in lib],
        iters=10) / n
    del lib
    res["plain_ms"] = time_ms(lambda: [interp_bwd_plain(*c) for c in captured], iters=3,
                              warmup=1) / n
    bounds = [bound_bwd(f, y, g, m) for f, y, _, g, m in captured]
    res["bound_ms"] = sum(b for b, _ in bounds) / n
    res["bound_by"] = bounds[0][1]
    return res


def gen_inputs(shape, seed: int, offset: int = 0):
    """Positions [B, H, W, V] over the padded grid R = H + 4, C = W + 4 and
    up to 3 px beyond it, with a NaN and an inf among them; with ``offset``,
    views that start that many elements into their buffers (so no longer
    16-byte aligned)."""
    import torch

    B, H, W, V = shape
    R, C = H + 4, W + 4
    n = B * H * W * V
    g = torch.Generator(device="cuda").manual_seed(seed)
    py = (torch.rand(n + offset, generator=g, device="cuda") * (R + 5) - 3)[offset:].view(shape)
    px = (torch.rand(n + offset, generator=g, device="cuda") * (C + 5) - 3)[offset:].view(shape)
    py.view(-1)[0] = float("nan")
    px.view(-1)[1] = float("inf")
    return py, px, R, C


def check_gen(derivative: bool, shape, timed: bool, mode: str = "bicubic",
              offset: int = 0) -> dict:
    """The weight-generation kernel (``derivative``: with K′) against its
    plain version, on positions ``offset`` elements into their buffers;
    with ``timed``, its time beside the plain version's and the bound: 8
    bytes read and 4 written per element, against the flops of the tap
    weights (and derivatives) of both axes over the fp32 rate."""
    import torch

    from paradis_torch.ops.interp_gen import bwd_gen_cuda, bwd_gen_plain, gen_cuda, gen_plain

    py, px, R, C = gen_inputs(shape, seed=sum(shape) + derivative, offset=offset)
    kernel_fn, plain_fn = (bwd_gen_cuda, bwd_gen_plain) if derivative else (gen_cuda, gen_plain)
    out = kernel_fn(py, px, R, C, mode)
    ref = plain_fn(py, px, R, C, mode)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    res = {"derivative": derivative, "mode": mode, "shape": list(shape), "R": R, "C": C,
           "total_mod_4": py.numel() % 4, "aligned_16": py.data_ptr() % 16 == 0,
           "max_abs_err": float(diff.max()), "limit": GEN_TOL,
           "ok": bool(torch.isfinite(out).all()) and bool((diff <= GEN_TOL).all())}
    if timed:
        res["ms"] = time_ms(lambda: kernel_fn(py, px, R, C, mode), iters=200)
        res["plain_ms"] = time_ms(lambda: plain_fn(py, px, R, C, mode), iters=20)
        res["library_ms"] = None  # no one PyTorch call computes it
        n = py.numel()
        # per axis 4 cubic weights (~6 flops each) and 4 compares and adds;
        # with the derivatives 4 more polynomials (~8 flops) and adds;
        # bilinear 2 weights and 2 compares and adds, and 2 selects
        taps = (24 + 8 + (36 if derivative else 0)) if mode == "bicubic" \
            else (2 + 4 + (4 if derivative else 0))
        flops = n * (2 * taps + (3 if derivative else 1))
        bytes_ms = 3 * n * 4 / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FP32_FLOPS * 1e3
        res["bound_ms"], res["bound_by"] = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                                            else (ops_ms, "operations"))
    return res


def mm_bound(nbytes: int, flops: int, cdt) -> tuple[float, str]:
    """(bound_ms, bound_by): bytes over the memory rate against flops over
    the rate of the operand type (bf16 on the tensor cores, else float32)."""
    import torch

    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / (PEAK_BF16_FLOPS if cdt == torch.bfloat16 else PEAK_FP32_FLOPS) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def mm_operands(shape, transposed: bool):
    """Normal wx [B,V,P,C] (or wxT [B,V,C,P]) and f [B,V,R,C], seeded by the
    shape alone, so that every variant of a layout gets the same operands."""
    import torch

    B, V, P, R, C = shape
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    w = torch.randn((B, V, C, P) if transposed else (B, V, P, C), generator=gen, device="cuda")
    f = torch.randn(B, V, R, C, generator=gen, device="cuda")
    return w, f


def digest(t) -> str:
    """SHA-256 of a tensor's bytes: equal digests, bitwise equal tensors."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def check_mm_blocks(kernel: str, cdt_name: str, shape, variant_digests: dict) -> dict:
    """``mm``'s (``kernel`` ``interp_mmT``: ``mmT``'s) output bitwise the same
    whatever the channel and position blocks: the digests of the
    ``check_mm`` variants of this kernel and operand type (same operands)
    and of one launch at each of ``MM_BLOCKS``."""
    import torch

    from paradis_torch.ops import interp_mm

    transposed = kernel == "interp_mmT"
    w, f = mm_operands(shape, transposed)
    launch = interp_mm.mmT_cuda if transposed else interp_mm.mm_cuda
    digests = dict(variant_digests)
    cdt = getattr(torch, cdt_name)
    for vb, pb in MM_BLOCKS:
        digests[f"vb{vb}-pb{pb}"] = digest(launch(w, f, cdt, vb, pb))
    same = len(set(digests.values())) == 1
    return {"kernel": kernel, "cdt": cdt_name, "shape": list(shape),
            "blocks": sorted(digests), "bitwise_equal_across_blocks": same, "ok": same}


def check_mm(variant: str, spec, shape, timed: bool) -> dict:
    """The contraction kernel of a variant named as in
    ``bench_interp.MM_VARIANTS``, ``spec`` its (cdt, vb, pb) (``mm`` on wx
    [B,V,P,C], ``mmT`` on wxT [B,V,C,P]) against its plain
    version on normal operands; with ``timed``, its time beside the plain
    version's, ``torch.matmul`` doing the same work (the [P, R] products,
    then the sum over r) and the bound: wx, f read once and out written once,
    against 2·B·V·P·R·C flops at the operands' rate.  ``einsum_ms`` is a note:
    ``einsum('bvpc,bvrc->bvp')`` sums f over r first, 36× less work."""
    import torch

    from paradis_torch.ops import interp_mm

    cdt, vb, pb = spec
    transposed = variant.startswith("mmT")
    B, V, P, R, C = shape
    w, f = mm_operands(shape, transposed)
    if transposed:
        kernel = lambda: interp_mm.mmT_cuda(w, f, cdt, vb, pb)  # noqa: E731
        plain = lambda: interp_mm.mmT_plain(w, f, cdt)  # noqa: E731
        lib = lambda: torch.matmul(f.to(cdt), w.to(cdt)).float().sum(-2)  # noqa: E731
        einsum = lambda: torch.einsum("bvcp,bvrc->bvp", w.to(cdt), f.to(cdt))  # noqa: E731
    else:
        kernel = lambda: interp_mm.mm_cuda(w, f, cdt, vb, pb)  # noqa: E731
        plain = lambda: interp_mm.mm_plain(w, f, cdt)  # noqa: E731
        lib = lambda: torch.matmul(w.to(cdt), f.to(cdt).transpose(-1, -2)).float().sum(-1)  # noqa: E731
        einsum = lambda: torch.einsum("bvpc,bvrc->bvp", w.to(cdt), f.to(cdt))  # noqa: E731
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    res = {"variant": variant, "kernel": "interp_mmT" if transposed else "interp_mm",
           "cdt": str(cdt).removeprefix("torch."), "vb": vb, "pb": pb, "shape": list(shape),
           "max_abs_err": err, "max_abs_plain": scale, "rel_err": err / scale,
           "limit": MM_TOL, "out_sha256": digest(out),
           "ok": bool(torch.isfinite(out).all()) and err <= MM_TOL * scale}
    if timed:
        res["ms"] = time_ms(kernel, iters=50)
        res["plain_ms"] = time_ms(plain, iters=10, warmup=2)
        res["library_ms"] = time_ms(lib, iters=20, warmup=2)
        res["einsum_ms"] = time_ms(einsum, iters=20, warmup=2)
        res["bound_ms"], res["bound_by"] = mm_bound(
            (w.numel() + f.numel() + out.numel()) * 4, 2 * B * V * P * R * C, cdt)
    return res


def check_bwd_mm(field_dtype: str, cdt_name: str, shape, timed: bool) -> dict:
    """The dense-backward contraction kernel against its plain version on a
    normal field, positions inside the padded grid and a cotangent in
    [-1, 1]; twice to the same bits (no atomics); d_px against d_py, equal up
    to float order with the stand-in weights.  With ``timed``, its time beside
    the plain version's, the same work through ``torch.bmm`` with bf16
    operands and float32 output (``out_dtype``), and the bound: field, py, px,
    g read once and d_field, d_py, d_px written once, against the 2·B·V·R·C·2P
    flops of ``tt`` and the 2·B·V·R·C·P of d_field at the operands' rate."""
    import torch

    from paradis_torch.ops import interp_mm

    B, V, P, R, C = shape
    cdt = getattr(torch, cdt_name)
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    field = torch.randn(B, V, R, C, generator=gen, device="cuda").to(getattr(torch, field_dtype))
    py = torch.rand(B, V, P, generator=gen, device="cuda") * (R - 5) + 2
    px = torch.rand(B, V, P, generator=gen, device="cuda") * (C - 5) + 2
    g = torch.rand(B, V, P, generator=gen, device="cuda") * 2 - 1
    kernel = lambda: interp_mm.bwd_mm_cuda(field, py, px, g, cdt)  # noqa: E731
    plain = lambda: interp_mm.bwd_mm_plain(field, py, px, g, cdt)  # noqa: E731
    outs, again, refs = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    res = {"field_dtype": field_dtype, "cdt": cdt_name, "shape": list(shape), "limit": MM_TOL,
           "deterministic": all(torch.equal(a, b) for a, b in zip(outs, again)),
           "d_px_vs_d_py_rel": float((outs[2] - outs[1]).abs().max() / outs[1].abs().max())}
    res["ok"] = res["deterministic"] and res["d_px_vs_d_py_rel"] <= MM_TOL
    res["max_abs_err"] = 0.0
    for name, o, r in zip(("d_field", "d_py", "d_px"), outs, refs):
        err, scale = float((o - r).abs().max()), float(r.abs().max())
        res[f"{name}_max_abs_err"], res[f"{name}_rel_err"] = err, err / scale
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["ok"] = res["ok"] and bool(torch.isfinite(o).all()) and err <= MM_TOL * scale
    if timed:
        res["ms"] = time_ms(kernel, iters=50)
        res["plain_ms"] = time_ms(plain, iters=10, warmup=2)
        rows = torch.arange(R, dtype=torch.float32, device="cuda")
        cols = torch.arange(C, dtype=torch.float32, device="cuda")

        def lib():
            wy = py[..., None, :] * rows[:, None]
            wxa = px[..., None, :] * cols[:, None]
            wx2 = torch.cat([wxa, wxa * 0.5], dim=-1).to(cdt).reshape(B * V, C, 2 * P)
            tt = torch.bmm(field.to(cdt).reshape(B * V, R, C), wx2,
                           out_dtype=torch.float32).reshape(B, V, R, 2 * P)
            d_py = g * (wy * 0.5 * tt[..., :P]).sum(-2)
            d_px = g * (wy * tt[..., P:]).sum(-2)
            wyg = (wy * g[..., None, :]).to(cdt).reshape(B * V, R, P)
            d_field = torch.bmm(wyg, wx2[..., :P].transpose(-1, -2), out_dtype=torch.float32)
            return d_field, d_py, d_px

        lib_out = lib()
        res["library_rel_err_vs_plain"] = max(
            float((a.reshape(r.shape) - r).abs().max() / r.abs().max())
            for a, r in zip(lib_out, refs))
        res["library_ms"] = time_ms(lib, iters=20, warmup=2)
        n_pos = B * V * P
        nbytes = field.numel() * field.element_size() + 3 * n_pos * 4 + B * V * R * C * 4 \
            + 2 * n_pos * 4
        res["bound_ms"], res["bound_by"] = mm_bound(nbytes, 2 * B * V * R * C * 3 * P, cdt)
    return res


def part_seconds(marks: list) -> dict:
    """``{part: seconds}`` from ``[(name, perf_counter()), ...]``: each part
    from the mark before it (the host clock; where a run's time goes)."""
    return {name: t - t_prev for (_, t_prev), (name, t) in zip(marks, marks[1:])}


def band_on(model, nlat: int, nlon: int) -> bool:
    """Whether the model's interpolation takes the row-banded kernels (a
    bound is set and the band gate passes at the padded grid)."""
    from paradis_torch.ops.interp_band import band_spec

    layer = model.layers[0].advection
    pad = 2 if layer.interpolation == "bicubic" else 1
    H, W = model.mesh_size_coarse
    return band_spec(H, W, H + 2 * pad, layer.interpolation, model.band_max_dy_pix) is not None


def launch_counts() -> list[int]:
    """The six interpolation kernel wrappers' launch counts: forward,
    backward, banded forward, banded backward, chunked forward, chunked
    backward."""
    from paradis_torch.ops import interp_cuda as ic

    return [ic.launches, ic.bwd_launches, ic.band_launches, ic.band_bwd_launches,
            ic.chunk_launches, ic.chunk_bwd_launches]


def reset_counts() -> None:
    from paradis_torch.ops import interp_cuda as ic

    ic.launches = ic.bwd_launches = ic.band_launches = ic.band_bwd_launches = 0
    ic.chunk_launches = ic.chunk_bwd_launches = 0


def expected_launches(fwd: int, bwd: int, banded: bool, chunk_rw: int) -> list[int]:
    """The six counts of a run whose path takes ``fwd`` forward and ``bwd``
    backward interpolations: all through the banded pair, the chunked pair
    or the unbanded pair."""
    slot = 2 if banded else 4 if chunk_rw else 0
    counts = [0] * 6
    counts[slot], counts[slot + 1] = fwd, bwd
    return counts


@contextlib.contextmanager
def interp_chunk_env(chunk_rw: int):
    """``PARADIS_INTERP_CHUNK`` set to ``chunk_rw`` (0: unchunked) for the
    block, and restored after."""
    old = os.environ.get("PARADIS_INTERP_CHUNK")
    os.environ["PARADIS_INTERP_CHUNK"] = str(chunk_rw)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PARADIS_INTERP_CHUNK", None)
        else:
            os.environ["PARADIS_INTERP_CHUNK"] = old


def run_forecast(dtype_name: str, card: str, grid=(NLAT, NLON), overrides=(),
                 chunk_rw: int = 0, ab_pairs: int = 0, capture: list | None = None) -> dict:
    """40-step full-width rollout on ``grid``; launch counts, finiteness,
    kernel-vs-plain.  With ``compute.interp_band_rad`` among ``overrides`` and
    the band gate on, every interpolation must go through the banded
    kernel; else, with ``chunk_rw`` (``PARADIS_INTERP_CHUNK`` for the run),
    through the chunked kernel.  ``ab_pairs`` more pairs of rollouts then run
    with chunking off and on in turns (off, on, on, off, ...) on the same
    model: where the host bounds the rate and drifts over a call, only turns
    compare the two paths.  ``capture``, a list, receives the inputs of the
    unbanded forward kernel's launches in the first rollout step (of the
    warm-up rollout, before any count is read)."""
    with interp_chunk_env(chunk_rw):
        return _run_forecast(dtype_name, card, grid, overrides, chunk_rw, ab_pairs, capture)


@contextlib.contextmanager
def recording_fwd(store: list, n: int):
    """``interp_cuda.interp_fwd_cuda`` wrapped for the block, so that the
    field, positions and mode of its first ``n`` calls are kept in ``store``
    (copied to the host, so the run's peak device memory is its own); the
    wrapper calls the kernel as before, and is removed after."""
    from paradis_torch.ops import interp_cuda as ic

    kernel = ic.interp_fwd_cuda

    def recorded(field, pix_y, pix_x, mode="bicubic"):
        if len(store) < n:
            store.append((field.cpu(), pix_y.cpu(), pix_x.cpu(), mode))
        return kernel(field, pix_y, pix_x, mode)

    ic.interp_fwd_cuda = recorded
    try:
        yield
    finally:
        ic.interp_fwd_cuda = kernel


def _run_forecast(dtype_name: str, card: str, grid, overrides, chunk_rw: int,
                  ab_pairs: int, capture: list | None) -> dict:
    import numpy as np
    import torch

    from paradis_torch.config import load_config
    from paradis_torch.forecast import make_forecast_rollout
    from paradis_torch.tools import bench_forecast
    from paradis_torch.tools.flagship import inputs

    marks = [("start", time.perf_counter())]
    dtype = getattr(torch, dtype_name)
    nlat, nlon = grid
    cfg = load_config(overrides=list(overrides))
    cfg.forecast.output_frequency = 1
    torch.cuda.reset_peak_memory_stats()
    model, d = flagship(cfg, grid, "cuda", dtype=dtype)
    n_layers = len(model.layers)
    n_params = sum(p.numel() for p in model.parameters())
    banded = band_on(model, nlat, nlon)
    impl = model.layers[0].advection.impl   # "xla": the dense path, no kernel
    batch = inputs(d, grid, STEPS, "cuda")
    rollout = make_forecast_rollout(model, cfg)

    warm = dict(batch, forcings=batch["forcings"][:, :2])
    with (recording_fwd(capture, n_layers) if capture is not None
          else contextlib.nullcontext()):
        rollout(warm, d["n_common"])
    torch.cuda.synchronize()
    marks.append(("setup", time.perf_counter()))

    # tools/bench_forecast's protocol, FORECAST_CHAIN's timed rollouts (the
    # last one's output kept)
    last = {"out": None, "rollouts": 0}

    def call():
        last["out"] = rollout(batch, d["n_common"])
        last["rollouts"] += 1

    reset_counts()
    bench = bench_forecast.time_rollout(call, "cuda", STEPS, *FORECAST_CHAIN)
    out = last.pop("out")
    counts = [[n / last["rollouts"] for n in launch_counts()]]
    times = [bench["best_s"]]
    # the path's forward kernel once per layer and step
    expected = expected_launches(n_layers * STEPS if impl == "auto" else 0, 0, banded, chunk_rw)
    median = float(np.median(times))
    marks.append(("rollouts", time.perf_counter()))
    ab_times, ab_ok = {"off": [], "on": []}, True
    for turn in (["off", "on", "on", "off"] * ab_pairs)[:2 * ab_pairs]:
        rw = chunk_rw if turn == "on" else 0
        with interp_chunk_env(rw):
            reset_counts()
            t0 = time.perf_counter()
            rollout(batch, d["n_common"])
            torch.cuda.synchronize()
            ab_times[turn].append(time.perf_counter() - t0)
            ab_ok = ab_ok and launch_counts() == expected_launches(n_layers * STEPS, 0, banded, rw)
    marks.append(("turns", time.perf_counter()))
    short = dict(batch, forcings=batch["forcings"][:, :PROFILE_STEPS])
    profile = profile_steps(lambda: rollout(short, d["n_common"]), PROFILE_STEPS,
                            median / STEPS)
    marks.append(("profile", time.perf_counter()))

    # first step again, routed through the plain interpolation on the card
    model_in = torch.cat([batch["input"], batch["forcings"][:, 0], batch["constants"]], dim=-1)
    with torch.inference_mode():
        model.set_interp_impl("plain")
        reset_counts()
        plain = model(model_in).float()
        plain_launches = launch_counts()
        model.set_interp_impl(impl)
    torch.cuda.synchronize()
    step_err = float((out[:, 0] - plain).abs().max())
    step_scale = float(plain.abs().max())
    marks.append(("plain_step", time.perf_counter()))
    res = {
        "dtype": dtype_name, "card": card, "grid": [nlat, nlon], "overrides": list(overrides),
        "impl": impl, "band_px": model.band_max_dy_pix, "banded": banded, "chunk_rw": chunk_rw,
        "params": n_params, "layers": n_layers,
        "out_shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
        "out_std": float(out.std()), "launches_per_rollout": counts,
        "expected_launches": expected, "rollout_s": times,
        "forecast_steps_per_s": STEPS / median, "bench_forecast": bench,
        "first_step_max_abs_diff_vs_plain": step_err, "first_step_max_abs": step_scale,
        "first_step_limit": STEP_TOL[dtype_name] * max(step_scale, 1e-3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile, "part_s": part_seconds(marks),
    }
    if ab_pairs:
        res["ab_rollout_s"] = ab_times
        res["ab_forecast_steps_per_s"] = {k: STEPS / float(np.median(v))
                                          for k, v in ab_times.items()}
    res["ok"] = (res["finite"] and all(c == expected for c in counts) and ab_ok
                 and plain_launches == [0] * 6
                 and res["out_shape"] == [1, STEPS, nlat, nlon, d["output_dim"]]
                 and step_err <= res["first_step_limit"] and res["out_std"] > 0)
    del model
    torch.cuda.empty_cache()
    return res


def run_train(dtype_name: str, card: str, grid=(NLAT, NLON), overrides=TRAIN_OVERRIDES,
              steps: int = TRAIN_STEPS, grad_tol=GRAD_TOL, chunk_rw: int = 0,
              capture: list | None = None) -> dict:
    """Full-width train steps on ``grid``: finiteness, loss decrease, launch
    counts and the first step's gradients through the kernels against the
    plain path.  Under ``compute.gradient_checkpointing`` the backward
    replays each layer's forward, so the forward kernel runs twice a layer.
    ``chunk_rw`` sets ``PARADIS_INTERP_CHUNK`` for the run.  ``capture``, a
    list, receives the inputs of the unbanded backward kernel's launches in
    the first train step (the warm-up step, before any count is read)."""
    with interp_chunk_env(chunk_rw):
        return _run_train(dtype_name, card, grid, overrides, steps, grad_tol, chunk_rw, capture)


@contextlib.contextmanager
def recording_bwd(store: list, n: int):
    """``interp_cuda.interp_bwd_cuda`` wrapped for the block, as
    ``recording_fwd`` wraps the forward: the field, positions, cotangent and
    mode of its first ``n`` calls are kept in ``store`` on the host."""
    from paradis_torch.ops import interp_cuda as ic

    kernel = ic.interp_bwd_cuda

    def recorded(field, pix_y, pix_x, g, mode="bicubic"):
        if len(store) < n:
            store.append((field.cpu(), pix_y.cpu(), pix_x.cpu(), g.cpu(), mode))
        return kernel(field, pix_y, pix_x, g, mode)

    ic.interp_bwd_cuda = recorded
    try:
        yield
    finally:
        ic.interp_bwd_cuda = kernel


def _run_train(dtype_name: str, card: str, grid, overrides, steps: int, grad_tol,
               chunk_rw: int, capture: list | None) -> dict:
    import numpy as np
    import torch

    from paradis_torch.config import load_config
    from paradis_torch.data import dyn_output_features
    from paradis_torch.sphere.geometry import equiangular_lat_lon
    from paradis_torch.tools import bench_highres
    from paradis_torch.train import (WeightedLoss, build_optimizer, build_schedule,
                                     create_train_state, make_train_step, set_learning_rate)

    marks = [("start", time.perf_counter())]
    nlat, nlon = grid
    overrides = list(overrides) + ([] if dtype_name == "bfloat16" else ["compute.use_amp=false"])
    cfg = load_config(overrides=overrides)
    S = int(cfg.model.forecast_steps)
    lat, _ = equiangular_lat_lon(nlat, nlon, include_poles=False)
    torch.cuda.reset_peak_memory_stats()
    model, d = flagship(cfg, grid, "cuda", dtype=None)
    n_layers = len(model.layers)
    banded = band_on(model, nlat, nlon)
    loss_fn = WeightedLoss.from_config(cfg, lat, dyn_output_features(cfg.features),
                                       nlon=nlon, device="cuda")
    optimizer = build_optimizer(cfg, model)
    lr_at, _ = build_schedule(cfg, int(cfg.training.max_steps))
    state = create_train_state(model, optimizer)
    train_step = make_train_step(model, loss_fn, cfg, optimizer)
    batch = train_batch(d, grid, S, "cuda")
    marks.append(("setup", time.perf_counter()))

    # the first step's parameter gradients, through the plain interpolation
    # and through the kernels (the step's loss at S = 1, unscaled)
    grads, grad_launches = {}, {}
    model_in = torch.cat([batch["input"], batch["forcings"][:, 0], batch["constants"]], dim=-1)
    for impl in ("plain", "auto"):
        model.set_interp_impl(impl)
        optimizer.zero_grad()
        reset_counts()
        loss_fn(model(model_in), batch["target"][:, 0]).backward()
        torch.cuda.synchronize()
        grad_launches[impl] = launch_counts()
        grads[impl] = torch.cat([p.grad.flatten() for p in optimizer.params])
    model.set_interp_impl("auto")
    optimizer.zero_grad()
    grad_scale = float(grads["plain"].abs().max())
    grad_err = float((grads["auto"] - grads["plain"]).abs().max()) / grad_scale
    del grads
    marks.append(("grad_check", time.perf_counter()))

    # each step's metrics (on the card) and launches; at 5.625° each step
    # ends in a synchronize and is timed alone, at 1.40625° the steps after
    # HR_WARM_STEPS are timed by tools/bench_highres's protocol (one chain)
    metrics, counts, times, bench = [], [], [], None

    def step():
        set_learning_rate(optimizer, lr_at(state.step))
        before = launch_counts()
        metrics.append(train_step(state, batch, d["n_common"]))
        counts.append([a - b for a, b in zip(launch_counts(), before)])

    for i in range(steps if grid != HR else HR_WARM_STEPS):
        t0 = time.perf_counter()
        with (recording_bwd(capture, n_layers * S) if capture is not None and i == 0
              else contextlib.nullcontext()):
            step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if grid == HR:
        bench = bench_highres.time_step(step, "cuda", 0, steps - HR_WARM_STEPS, 1)
        times.append(bench["best_s"])
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    del metrics
    median = float(np.median(times[1:] if grid != HR else times[-1:]))
    marks.append(("steps", time.perf_counter()))

    def traced():
        for _ in range(TRAIN_PROFILE_STEPS):
            train_step(state, batch, d["n_common"])

    profile = profile_steps(traced, TRAIN_PROFILE_STEPS, median)
    marks.append(("profile", time.perf_counter()))
    # the optimizer's share: one more update on the last gradients, timed
    # alone on the host clock and traced
    opt_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.step()
        torch.cuda.synchronize()
        opt_times.append(time.perf_counter() - t0)
    opt_s = float(np.median(opt_times))
    opt_profile = profile_steps(optimizer.step, 1, opt_s)
    marks.append(("optimizer", time.perf_counter()))

    # the path's forward and backward kernel once per layer and forecast
    # step; the forward twice under checkpointing with remat_policy none (the
    # replay), once under advect and advect_pos (the replay keeps its output)
    policy = model.resolve_remat_policy() if model.gradient_checkpointing else None
    fwd = n_layers * S * (2 if policy in ("none", "") else 1)
    expected = expected_launches(fwd, n_layers * S, banded, chunk_rw)
    res = {
        "dtype": dtype_name, "card": card, "grid": [nlat, nlon], "overrides": overrides,
        "band_px": model.band_max_dy_pix, "banded": banded, "chunk_rw": chunk_rw,
        "gradient_checkpointing": model.gradient_checkpointing, "remat_policy": policy,
        "loss": loss_fn.kind,
        "model_dtype": str(model.dtype),
        "optimizer": optimizer.name, "ns_dtype": str(optimizer.ns_dtype), "S": S,
        "layers": n_layers, "params": sum(p.numel() for p in model.parameters()),
        "losses": losses, "grad_norms": gnorms, "lrs": [lr_at(i) for i in range(steps)],
        "launches_per_step": counts, "expected_launches": expected, "step_s": times,
        "train_steps_per_s": 1.0 / median, "bench_highres": bench,
        "first_step_grad_launches": grad_launches,
        "first_step_grad_max_abs": grad_scale, "first_step_grad_rel_err_vs_plain": grad_err,
        "first_step_grad_limit": grad_tol[dtype_name],
        "optimizer_step_wall_ms": opt_s * 1e3, "optimizer_share_of_step_wall": opt_s / median,
        "optimizer_profile": opt_profile,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile, "part_s": part_seconds(marks),
    }
    res["ok"] = (all(np.isfinite(losses)) and all(np.isfinite(gnorms))
                 and losses[-1] < losses[0]
                 and all(c == expected for c in counts)
                 and grad_launches == {"plain": [0] * 6, "auto": expected}
                 and model.dtype == getattr(torch, dtype_name)
                 and grad_err <= grad_tol[dtype_name])
    del model, optimizer, state, train_step
    torch.cuda.empty_cache()
    return res


def check_sht(card: str) -> dict:
    """The SHT analysis of a seeded ``SHT_SHAPE`` field on the card against a
    float64 CPU analysis of the same field (numpy's FFT and the float64
    Legendre table), and the analysis and the AMSE forward + backward timed
    beside the Legendre product's bound."""
    import numpy as np
    import torch

    from paradis_torch.ops import sht
    from paradis_torch.train.amse import AMSELoss

    B, H, W, C = SHT_SHAPE
    rng = np.random.default_rng(7)
    x = rng.normal(size=SHT_SHAPE).astype(np.float32)
    y = (0.7 * x + rng.normal(scale=0.8, size=SHT_SHAPE)).astype(np.float32)
    transform = sht.RealSHT(H, W)
    L, M = transform.lmax, transform.mmax
    xd = torch.tensor(x, device="cuda")
    coef = transform.analysis(xd)
    torch.cuda.synchronize()

    cos_t, w = sht._colat_quadrature(H, False)
    table = sht._legendre_table(L, M, cos_t) * w[None, None, :]
    fm = np.fft.rfft(x.astype(np.float64), axis=-2)[..., :M, :] * (2.0 * np.pi / W)
    ref = np.einsum("lmh,...hmc->...lmc", table, fm)
    err = float(np.abs(coef.cpu().numpy().astype(np.complex128) - ref).max()
                / np.abs(ref).max())

    yd = torch.tensor(y, device="cuda")
    weights = torch.tensor(rng.uniform(0.2, 2.0, size=C), dtype=torch.float32, device="cuda")
    loss_fn = AMSELoss(H, W)
    pred = xd.clone().requires_grad_()

    def amse_fwd_bwd():
        torch.autograd.grad(loss_fn(pred, yd, weights), pred)

    loss = float(loss_fn(pred, yd, weights).detach())
    ms = time_ms(lambda: transform.analysis(xd), 50)
    amse_ms = time_ms(amse_fwd_bwd, 20)
    # the Legendre product: table [M, L, H] @ [M, H, 2·B·C] (real and imaginary)
    K = 2 * B * C
    nbytes = 4 * (M * L * H + M * H * K + M * L * K)
    flops = 2 * M * L * H * K
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3
    res = {"card": card, "shape": list(SHT_SHAPE), "lmax": L, "mmax": M,
           "coef_shape": list(coef.shape), "coef_dtype": str(coef.dtype),
           "max_rel_err_vs_float64": err, "limit": SHT_TOL,
           "analysis_ms": ms, "legendre_bytes": nbytes, "legendre_flops": flops,
           "legendre_bound_ms": bound_ms,
           "bound_by": "bytes" if nbytes / PEAK_BYTES_PER_S > flops / PEAK_FP32_FLOPS
           else "operations",
           # two analyses forward and the prediction's one backward
           "amse_fwd_bwd_ms": amse_ms, "amse_legendre_bound_ms": 3 * bound_ms,
           "amse_loss": loss}
    res["ok"] = (err <= SHT_TOL and res["coef_shape"] == [B, L, M, C]
                 and coef.dtype == torch.complex64 and np.isfinite(loss) and loss > 0)
    return res


def _flat_state(obj, prefix: str) -> dict:
    """Every tensor and number of a nested state dict, by path (tensors copied)."""
    if isinstance(obj, dict):
        return {k: v for key, val in obj.items()
                for k, v in _flat_state(val, f"{prefix}/{key}").items()}
    if isinstance(obj, (list, tuple)):
        return {k: v for i, val in enumerate(obj)
                for k, v in _flat_state(val, f"{prefix}/{i}").items()}
    return {prefix: obj.clone() if hasattr(obj, "clone") else obj}


def run_checkpoint(card: str) -> dict:
    """Save, restore and resume at 1.40625° bf16 with the default loss, then
    a weights-only transfer of that checkpoint onto the 5.625° grid.

    Two uninterrupted ``CKPT_STEPS``-step runs from one seed give the noise
    floor (#6 sums d_field with shared-memory float atomics: not bitwise
    reproducible).  A third run stops after half the steps and saves through
    ``CheckpointManager``; a model and optimizer built afresh from another
    seed restore it through the root's ``last.json`` (bitwise what was saved)
    and take the other half, which must land within 4× the uninterrupted
    runs' spread of them (``CKPT_FLOOR`` of the largest value where that
    spread is 0).  ``load_params`` of the step checkpoint into a 5.625° model
    re-interpolates the GlobalBias U/V factors, and one forecast step through
    #1 must be finite."""
    import tempfile

    import numpy as np
    import torch

    from paradis_torch.config import load_config
    from paradis_torch.data import dyn_output_features
    from paradis_torch.forecast import make_forecast_rollout
    from paradis_torch.ops.resize import linear_interp_matrix
    from paradis_torch.sphere.geometry import equiangular_lat_lon
    from paradis_torch.train import (WeightedLoss, build_optimizer, build_schedule,
                                     create_train_state, make_train_step, set_learning_rate)
    from paradis_torch.train.checkpoint import CheckpointManager, load_params

    cfg = load_config(overrides=HR_TRAIN_OVERRIDES)
    d = flagship_dims(cfg)
    S = int(cfg.model.forecast_steps)
    seed = int(cfg.init.seed)
    lat, _ = equiangular_lat_lon(*HR, include_poles=False)
    loss_fn = WeightedLoss.from_config(cfg, lat, dyn_output_features(cfg.features), nlon=HR[1],
                                       device="cuda")
    lr_at, _ = build_schedule(cfg, int(cfg.training.max_steps))
    batch = train_batch(d, HR, S, "cuda")
    accum = int(cfg.training.accumulate_grad_batches)

    def fresh(model_seed):
        model, _ = flagship(cfg, HR, "cuda", dtype=None, seed=model_seed)
        optimizer = build_optimizer(cfg, model)
        return create_train_state(model, optimizer), make_train_step(model, loss_fn, cfg,
                                                                     optimizer)

    def train(state, step_fn, n):
        losses = []
        for _ in range(n):
            set_learning_rate(state.optimizer, lr_at(state.step))
            losses.append(float(step_fn(state, batch, d["n_common"])["loss"]))
        return losses

    def flat_params(model):
        return torch.cat([p.detach().flatten() for p in model.parameters()])

    runs = []
    for _ in range(2):
        state, step_fn = fresh(seed)
        runs.append((train(state, step_fn, CKPT_STEPS), flat_params(state.model).clone()))
        del state, step_fn
    (loss_a, final_a), (loss_b, final_b) = runs
    loss_spread = max(abs(a - b) for a, b in zip(loss_a, loss_b))
    param_spread = float((final_a - final_b).abs().max())
    del final_b

    half = CKPT_STEPS // 2
    tmp = tempfile.TemporaryDirectory(prefix="paradis-ckpt-")
    root = Path(tmp.name)
    try:
        state, step_fn = fresh(seed)
        first = train(state, step_fn, half)
        mgr = CheckpointManager(root, step_every=half, accumulate_grad_batches=accum)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved_ok = mgr.maybe_save_step(state.step, state)
        save_s = time.perf_counter() - t0
        saved = _flat_state({"params": dict(state.model.named_parameters()),
                             "optimizer": state.optimizer.state_dict(),
                             "step": state.step, "micro_step": state.micro_step}, "")
        n_params = sum(p.numel() for p in state.model.parameters())
        del state, step_fn
        torch.cuda.empty_cache()
        files = [f for f in root.rglob("*") if f.is_file()]
        ckpt_bytes = sum(f.stat().st_size for f in files)
        pointer = CheckpointManager(root).latest_path()

        state, step_fn = fresh(seed + 1)
        differed = not torch.equal(flat_params(state.model), torch.cat(
            [saved[f"/params/{n}"].flatten() for n, _ in state.model.named_parameters()]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointManager(root).restore(state, root)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored = _flat_state({"params": dict(state.model.named_parameters()),
                                "optimizer": state.optimizer.state_dict(),
                                "step": state.step, "micro_step": state.micro_step}, "")
        mismatched = sorted(set(saved) ^ set(restored)) + sorted(
            k for k in set(saved) & set(restored)
            if not (saved[k].dtype == restored[k].dtype and saved[k].device == restored[k].device
                    and torch.equal(saved[k], restored[k])
                    if isinstance(saved[k], torch.Tensor) else saved[k] == restored[k]))
        del saved, restored
        second = train(state, step_fn, CKPT_STEPS - half)
        final_r = flat_params(state.model)
        del state, step_fn
        resumed_loss_err = max(abs(a - b) for a, b in zip(second, loss_a[half:]))
        resumed_param_err = float((final_r - final_a).abs().max())
        param_scale = float(final_a.abs().max())
        del final_r, final_a
        torch.cuda.empty_cache()

        # weights-only transfer onto the 5.625° grid, from the state-only
        # step checkpoint: U/V re-interpolated 256 → 64 and 128 → 32
        lr_cfg = load_config()
        lr_cfg.forecast.output_frequency = 1
        lr_d = flagship_dims(lr_cfg)
        small, _ = flagship(lr_cfg, (NLAT, NLON), "cuda", dtype=None, seed=seed + 2)
        load_params(root, small)
        src = torch.load(root / "steps" / f"{half:08d}" / "state.pt", map_location="cpu",
                         weights_only=True)["params"]
        uv_err, uv_shapes, other_equal = 0.0, set(), True
        for name, p in small.named_parameters():
            if name.rsplit(".", 1)[-1] in ("U", "V"):
                mat = torch.tensor(linear_interp_matrix(src[name].shape[-1], p.shape[-1]))
                uv_err = max(uv_err, float((p.detach().cpu() - src[name] @ mat.T).abs().max()))
                uv_shapes.add((tuple(src[name].shape), tuple(p.shape)))
            else:
                other_equal = other_equal and torch.equal(p.detach().cpu(), src[name])
        del src
        rng = np.random.default_rng(0)
        fc_batch = {
            "input": rng.normal(size=(1, NLAT, NLON, lr_d["n_common"] * lr_d["n_time"])),
            "forcings": rng.normal(size=(1, 1, NLAT, NLON, lr_d["n_forcings"] * lr_d["n_time"])),
            "constants": rng.normal(size=(1, NLAT, NLON, lr_d["n_const"])),
        }
        fc_batch = {k: torch.tensor(v, dtype=torch.float32, device="cuda")
                    for k, v in fc_batch.items()}
        reset_counts()
        out = make_forecast_rollout(small, lr_cfg)(fc_batch, lr_d["n_common"])
        torch.cuda.synchronize()
        fc_launches = launch_counts()
        n_layers = len(small.layers)
        fc_expected = expected_launches(n_layers, 0, band_on(small, NLAT, NLON), 0)
        fc_finite = bool(torch.isfinite(out).all())
        fc_shape = list(out.shape)
        del small, out
    finally:
        tmp.cleanup()
    torch.cuda.empty_cache()

    loss_scale = max(abs(v) for v in loss_a)
    loss_limit = 4 * loss_spread if loss_spread > 0 else CKPT_FLOOR * loss_scale
    param_limit = 4 * param_spread if param_spread > 0 else CKPT_FLOOR * param_scale
    res = {
        "card": card, "grid": list(HR), "dtype": "bfloat16", "loss": loss_fn.kind,
        "params": n_params, "steps": CKPT_STEPS, "saved_after": half,
        "accumulate_grad_batches": accum,
        "uninterrupted_losses": [loss_a, loss_b], "loss_spread": loss_spread,
        "param_spread": param_spread, "param_max_abs": param_scale,
        "resumed_losses": first + second, "resumed_loss_err": resumed_loss_err,
        "loss_limit": loss_limit, "resumed_param_err": resumed_param_err,
        "param_limit": param_limit,
        "save_s": save_s, "restore_s": restore_s, "checkpoint_bytes": ckpt_bytes,
        "files": sorted(str(f.relative_to(root)) for f in files),
        "last_json": str(pointer.relative_to(root.resolve())) if pointer else None,
        "restored_bitwise": not mismatched, "mismatched": mismatched[:10],
        "fresh_model_differed": differed,
        "transfer_uv_shapes": sorted(uv_shapes), "transfer_uv_max_abs_err": uv_err,
        "transfer_other_params_equal": other_equal,
        "transfer_forecast_shape": fc_shape, "transfer_forecast_finite": fc_finite,
        "transfer_forecast_launches": fc_launches, "transfer_expected_launches": fc_expected,
    }
    res["ok"] = (saved_ok and not mismatched and differed
                 and res["last_json"] == f"steps/{half:08d}"
                 and all(np.isfinite(loss_a + loss_b + first + second))
                 and resumed_loss_err <= loss_limit and resumed_param_err <= param_limit
                 and len(uv_shapes) > 0
                 and all(a[:-1] == b[:-1] and (a[-1], b[-1]) in ((HR[0], NLAT), (HR[1], NLON))
                         for a, b in uv_shapes)
                 and uv_err <= 1e-6 and other_equal
                 and fc_finite and fc_shape == [1, 1, NLAT, NLON, lr_d["output_dim"]]
                 and fc_launches == fc_expected and fc_launches[0] == n_layers)
    return res



def dir_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in Path(root).rglob("*") if f.is_file())


def data_stores(root: Path) -> dict:
    """[data]'s synthetic WB2-shaped raw stores at 1.40625° and at 5.625°
    (the 13 levels of ``configs/default.yaml``, ``DATA_TIMES`` six-hourly
    times, Blosc-LZ4 as a WeatherBench-2 download), built and preprocessed
    with the port's ``synthetic`` and ``preprocess``: paths, seconds and
    bytes on disk."""
    from paradis_torch.config import load_config
    from paradis_torch.data.preprocess import preprocess
    from paradis_torch.data.synthetic import build_raw_store

    levels = tuple(int(v) for v in load_config().features.pressure_levels)
    stores = {}
    for grid in (HR, (NLAT, NLON)):
        raw, store = root / f"raw{grid[0]}", root / f"store{grid[0]}"
        t0 = time.perf_counter()
        build_raw_store(str(raw), nlat=grid[0], nlon=grid[1], n_times=DATA_TIMES,
                        levels=levels, start="2000-01-01T00:00:00", seed=0,
                        compressor=WB2_BLOSC, wb2_layout=True)
        t1 = time.perf_counter()
        preprocess(str(raw), str(store))
        t2 = time.perf_counter()
        stores[f"{grid[0]}x{grid[1]}"] = {
            "path": str(store), "build_s": t1 - t0, "preprocess_s": t2 - t1,
            "raw_bytes": dir_bytes(raw), "store_bytes": dir_bytes(store)}
    return stores


def wait_ready(ready: Path, proc, what: str) -> dict:
    """The record ``prepare_export`` writes at ``ready``, waiting for it
    (the phase fails if that process ends or stalls first)."""
    t0 = time.perf_counter()
    while not ready.is_file():
        if proc.poll() is not None or time.perf_counter() - t0 > 600:
            raise SystemExit(f"[export]'s preparation ended or stalled ({proc.poll()}) "
                             f"before {what}: see {ready.parent}")
        time.sleep(1)
    return json.loads(ready.read_text())


def write_ready(ready: Path, record: dict) -> None:
    ready.with_suffix(".tmp").write_text(json.dumps(record))
    ready.with_suffix(".tmp").rename(ready)


def run_data(card: str, root: Path, prepared) -> dict:
    """The port's data pipeline on this host and the card: the native host
    library (required), [data]'s stores (``data_stores``, made by
    ``prepared``, the ``prepare_export`` process), the median ms to assemble
    one 1.40625° sample and its bytes; the host → device copy of one batch,
    pinned and ``non_blocking`` against pageable; and the loader's first
    batch on the card bitwise against the same batch assembled as numpy."""
    import numpy as np
    import torch

    from paradis_torch.config import load_config
    from paradis_torch.data import native
    from paradis_torch.data.dataset import ERA5Dataset
    from paradis_torch.data.pipeline import BatchLoader, collate

    t0 = time.perf_counter()
    native.require()
    res = {"card": card, "native_library": native._lib_path().name,
           "native_build_s": time.perf_counter() - t0,
           "stores": wait_ready(root / DATA_READY, prepared, "[data]'s stores")}

    cfg = load_config(overrides=[f"dataset.root_dir={root / f'store{HR[0]}'}"])
    ds = ERA5Dataset(cfg.dataset.root_dir, "2000-01-01", "2000-01-03",
                     forecast_steps=int(cfg.model.forecast_steps), cfg=cfg)
    times, sample = [], None
    for i in range(DATA_SAMPLES):
        t0 = time.perf_counter()
        sample = ds[i]
        times.append(time.perf_counter() - t0)
    batch = collate([sample])
    res.update(features=len(ds.features), samples=len(ds),
               sample_shapes={k: list(v.shape) for k, v in batch.items()},
               sample_bytes=sum(a.nbytes for a in sample),
               assemble_ms=[t * 1e3 for t in times],
               assemble_ms_median=float(np.median(times)) * 1e3)

    def copy(pinned: bool):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = {k: (torch.from_numpy(v).pin_memory().to("cuda", non_blocking=True) if pinned
                   else torch.from_numpy(v).to("cuda")) for k, v in batch.items()}
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    h2d = {"pageable": [], "pinned": []}
    for _ in range(H2D_REPEATS):
        for kind in ("pageable", "pinned"):
            h2d[kind].append(copy(kind == "pinned")[0] * 1e3)
    # the copy alone, from buffers pinned beforehand (CUDA events)
    host = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(H2D_REPEATS):
        for v in host.values():
            v.to("cuda", non_blocking=True)
    end.record()
    end.synchronize()
    res.update(h2d_pageable_ms=float(np.median(h2d["pageable"])),
               h2d_pinned_ms=float(np.median(h2d["pinned"])),
               h2d_pinned_copy_only_ms=start.elapsed_time(end) / H2D_REPEATS,
               batch_bytes=sum(v.nbytes for v in batch.values()))
    res["h2d_pinned_copy_only_gb_per_s"] = (res["batch_bytes"] / 1e6
                                            / res["h2d_pinned_copy_only_ms"])

    first = next(iter(BatchLoader(ds, 1, shuffle=False, device="cuda")))
    expected = collate([ds[0]])
    res["loader_bitwise"] = {k: bool(first[k].device.type == "cuda"
                                     and np.array_equal(first[k].cpu().numpy(), v))
                             for k, v in expected.items()}
    res["ok"] = (all(res["loader_bitwise"].values())
                 and all(st["store_bytes"] > 0 for st in res["stores"].values()))
    return res


def fio_inputs(root: Path, grid) -> dict:
    """[forecast-io]'s synthetic WB2-shaped raw store of ``grid``, its
    preprocessed store and the seeded fp32 flagship's weights
    (``save_params``; drawn on the CPU, the same bits a model built on the
    card has), with the seconds and bytes."""
    import torch

    from paradis_torch.config import load_config
    from paradis_torch.data.dataset import ERA5Dataset
    from paradis_torch.data.preprocess import preprocess
    from paradis_torch.data.synthetic import build_raw_store
    from paradis_torch.model import Paradis
    from paradis_torch.train.checkpoint import save_params

    n_times, end_date, _, overrides = FIO_GRIDS[grid]
    raw, store = root / f"fio_raw{grid[0]}", root / f"fio_store{grid[0]}"
    t0 = time.perf_counter()
    build_raw_store(str(raw), nlat=grid[0], nlon=grid[1], n_times=n_times,
                    levels=tuple(int(v) for v in load_config().features.pressure_levels),
                    start="2000-01-01T00:00:00", seed=0, compressor=WB2_BLOSC,
                    wb2_layout=True)
    t1 = time.perf_counter()
    preprocess(str(raw), str(store))
    t2 = time.perf_counter()
    cfg = load_config(overrides=[f"dataset.root_dir={store}", *overrides])
    cfg.forecast.enable = True
    cfg.model.forecast_steps = STEPS
    cfg.compute.use_amp = False
    ds = ERA5Dataset(str(store), FIO_START, end_date, forecast_steps=STEPS, cfg=cfg,
                     time_interval=FIO_INTERVAL, prediction_stage=True)
    model = Paradis.from_config(cfg, input_dim=ds.num_in_features,
                                output_dim=ds.num_out_features, lat_deg=ds.lat,
                                lon_deg=ds.lon, dtype=torch.float32, device="cpu")
    save_params(root / f"fio_params{grid[0]}.pt", model)
    return {"grid": list(grid), "raw_times": n_times, "build_s": t1 - t0,
            "preprocess_s": t2 - t1, "raw_bytes": dir_bytes(raw),
            "store_bytes": dir_bytes(store)}


def prepare_export(root: Path, data_root: Path) -> int:
    """``--worker export ROOT DATA_ROOT``: host work of the later phases made
    ahead, in a process of its own while the smoke's 1.40625° phases
    (device-bound) run: [data]'s stores (``data_stores``, then the
    ``DATA_READY`` file), [forecast-io]'s stores and weights at both grids
    (``fio_inputs``; after each grid its ``FIO_READY`` file), and ``python -m
    paradis_torch.cli.export`` at its
    default ``--device cuda`` on them into ``ROOT/artifact32`` (host work:
    traced in the smoke's own process, after the earlier phases, the
    rollout took 4.3× as long), then the 1.40625° forward program
    (``export_hr_forward``); their seconds and output into
    ``ROOT/export_prep.json``; then ``host_tools``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    write_ready(data_root / DATA_READY, data_stores(data_root))
    for grid in ((NLAT, NLON), HR):
        write_ready(root / FIO_READY.format(grid[0]), fio_inputs(root, grid))
    art = root / "artifact32"
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "paradis_torch.cli.export", "--checkpoint-path",
         str(root / f"fio_params{NLAT}.pt"), "--output-dir", str(art),
         f"dataset.root_dir={root / f'fio_store{NLAT}'}", f"model.forecast_steps={STEPS}",
         "forecast.output_frequency=1", *LOOP_DATES[:2]],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=900)
    record = {"cli_export_s": time.perf_counter() - t0, "returncode": done.returncode,
              "stdout": done.stdout[-3000:], "stderr": done.stderr[-3000:]}
    t0 = time.perf_counter()
    export_hr_forward(root / f"artifact{HR[0]}")
    record["hr_export_s"] = time.perf_counter() - t0
    write_ready(root / EXPORT_READY, record)
    write_ready(root / TOOLS_READY, host_tools(data_root))
    return 0


def export_hr_forward(art: Path) -> None:
    """[export]'s 1.40625° artifact: the seeded fp32 flagship with
    ``compute.interp_band_rad`` (``EXPORT_HR_STEPS`` steps, every step
    stored), its forward program alone (its scanned rollout at full width
    would add ~80 s of trace; ``tests/test_torch_export_gpu.py`` runs a
    banded ``rollout.pt2``), traced on the card into ``art``."""
    import torch

    from paradis_torch.config import load_config
    from paradis_torch.forecast.export import save_artifact

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(overrides=["compute.use_amp=false", *HR_OVERRIDES,
                                 f"model.forecast_steps={EXPORT_HR_STEPS}",
                                 "forecast.output_frequency=1"])
    model, d = flagship(cfg, HR, "cuda")
    save_artifact(art, model, cfg, batch_size=1, nlat=HR[0], nlon=HR[1],
                  input_dim=d["input_dim"], output_dim=d["output_dim"],
                  n_common=d["n_common"], include_rollout=False)


def host_tools(data_root: Path) -> dict:
    """The host-bound tools, in ``prepare_export``'s process after the
    export: ``tools/bench_pipeline`` on [data]'s stores (the host path, and
    with the place stage to the card) and ``tools/roofline --cost`` at both
    grids (one train step on meta tensors under ``FlopCounterMode``, no card
    time), each with its seconds."""
    from paradis_torch.tools import bench_pipeline, roofline

    out = {}
    for grid in (HR, (NLAT, NLON)):
        t0 = time.perf_counter()
        rec = bench_pipeline.main(["--store", str(data_root / f"store{grid[0]}"),
                                   "--samples", str(PIPELINE_SAMPLES),
                                   *[a for o in LOOP_DATES[:2] for a in ("--override", o)]])
        out[f"bench_pipeline {grid[0]}x{grid[1]}"] = dict(rec, seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        rec = roofline.main(["--cost", "--device", "cpu", "--nlat", str(grid[0]),
                             "--nlon", str(grid[1])])
        out[f"roofline {grid[0]}x{grid[1]}"] = dict(rec, seconds=time.perf_counter() - t0)
    return out


def run_forecast_io(card: str, root: Path, prepared) -> dict:
    """``python -m paradis_torch.cli.forecast`` (its ``main``, in process) on
    the card at both grids from synthetic WB2-shaped stores built and
    preprocessed here, with the seeded flagship's weights saved by
    ``save_params``: 40 fp32 steps, batch 1, writes every
    ``FIO_WRITE_EVERY`` stored steps.  Gates: the native library present
    and every chunk Blosc-zstd; the store's td 1..40 within
    ``BITROUND_STEP`` of the same batch rolled out by
    ``make_forecast_rollout`` and put through the port's postprocessing in
    memory (that rollout, timed, is also the device-only rate); every stored
    forecast value finite; the dewpoint depression ≤ 30; output-only
    channels NaN at td 0 and finite after; exact launch counts; finite
    ``evaluate_store`` RMSEs at ``FIO_LEADS`` against the raw store
    (``WB2TruthReader``) and the preprocessed one (``TruthReader``).
    The stores and weights come from ``prepared``, the ``prepare_export``
    process."""
    import numpy as np
    import torch

    from paradis_torch.cli import forecast as forecast_cli
    from paradis_torch.config import load_config
    from paradis_torch.data import native, zarrlite
    from paradis_torch.data.dataset import ERA5Dataset
    from paradis_torch.data.pipeline import collate_prediction
    from paradis_torch.forecast import make_forecast_rollout
    from paradis_torch.forecast.evaluate import evaluate_store
    from paradis_torch.forecast.writer import _renamed_vars, chunk_codecs
    from paradis_torch.model import Paradis
    from paradis_torch.utils.postprocessing import (convert_cartesian_to_spherical_winds,
                                                    denormalize_forecast, feature_indices)
    from paradis_torch.utils.thermo import dewpoint_depression

    native.require()
    res = {"card": card, "ok": True}
    for grid, (n_times, end_date, inits, overrides) in FIO_GRIDS.items():
        key = f"{grid[0]}x{grid[1]}"
        raw, store = root / f"fio_raw{grid[0]}", root / f"fio_store{grid[0]}"
        # the stores and weights come from [export]'s preparation, started in
        # a process of its own before [train-remat]
        r = wait_ready(root / FIO_READY.format(grid[0]), prepared, f"the {key} store")

        # the configuration the CLI builds
        args = [f"dataset.root_dir={store}", *overrides]
        cfg = load_config(overrides=args)
        cfg.forecast.enable = True
        cfg.model.forecast_steps = STEPS
        cfg.compute.use_amp = False
        ds = ERA5Dataset(str(store), FIO_START, end_date, forecast_steps=STEPS, cfg=cfg,
                         time_interval=FIO_INTERVAL, prediction_stage=True)
        model = Paradis.from_config(cfg, input_dim=ds.num_in_features,
                                    output_dim=ds.num_out_features, lat_deg=ds.lat,
                                    lon_deg=ds.lon, dtype=torch.float32, device="cuda")
        params = root / f"fio_params{grid[0]}.pt"
        # the weights on disk are this model's (seeded, drawn on the CPU)
        saved = torch.load(params, weights_only=True)["params"]
        r["params_as_model"] = all(torch.equal(saved[n], p.detach().cpu())
                                   for n, p in model.named_parameters())

        # the same batches rolled out in memory: the reference, and the device rate
        rollout = make_forecast_rollout(model, cfg)
        refs, device_s = [], []
        for i in range(len(ds)):
            batch = {k: v if k == "index" else torch.from_numpy(v).cuda()
                     for k, v in collate_prediction([ds[i]]).items()}
            rollout(dict(batch, forcings=batch["forcings"][:, :2]), ds.num_common_features)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stored = rollout(batch, ds.num_common_features)
            torch.cuda.synchronize()
            device_s.append(time.perf_counter() - t0)
            refs.append(stored.cpu().numpy())
        del model
        torch.cuda.empty_cache()

        out = root / f"fio_forecast{grid[0]}.zarr"
        reset_counts()
        t0 = time.perf_counter()
        stats = forecast_cli.main([
            "--checkpoint-path", str(params), "--output-file", str(out),
            "--forecast-steps", str(STEPS), "--sampling-interval", FIO_INTERVAL,
            "--start-date", FIO_START, "--end-date", end_date, "--batch-size", "1",
            "--write-every-n", str(FIO_WRITE_EVERY), "--device", "cuda", *args])
        cli_s = time.perf_counter() - t0
        launches = launch_counts()
        expected = expected_launches(8 * STEPS * inits, 0, grid == HR, 0)
        r.update(cli_s=cli_s, stats=stats, launches=launches, expected_launches=expected,
                 samples=len(ds), forecast_steps_per_s_cli=stats["forecast_steps_per_s"],
                 forecast_steps_per_s_device=STEPS * len(ds) / sum(device_s),
                 device_rollout_s=device_s, write_bytes=dir_bytes(out))

        # the store read back against the in-memory postprocessing
        codecs = chunk_codecs(out)
        r["codecs"] = sorted(set().union(*codecs.values()))
        g = zarrlite.open_store(out)
        levels = [int(v) for v in cfg.features.pressure_levels]
        features = list(ds.dyn_output_features)
        atmo, surf = _renamed_vars(cfg)
        worst, finite = 0.0, True
        for i, stored in enumerate(refs):
            x = np.moveaxis(stored, -1, 2).copy()  # [1, 40, C, H, W], normalized
            denormalize_forecast(x, ds)
            convert_cartesian_to_spherical_winds(ds.lat, ds.lon, levels, x, features)
            levels_pa = np.asarray(levels, np.float64)[:, None, None] * 100.0
            fields = {o: x[0][:, feature_indices(n, features)] for n, o in atmo}
            fields.update({o: x[0][:, features.index(n)] for n, o in surf})
            fields["dewpoint_depression"] = dewpoint_depression(
                fields["specific_humidity"], fields["temperature"], levels_pa
            ).astype(np.float32)
            for name, ref in fields.items():
                got = np.asarray(g[name][i, 1:], np.float64)
                finite = finite and bool(np.isfinite(got).all())
                gap = np.abs(got - ref) - BITROUND_STEP * np.abs(ref)
                worst = max(worst, float(np.nanmax(gap)))
        dd = np.asarray(g["dewpoint_depression"][...])
        tp = np.asarray(g["total_precipitation_6hr"][...])
        r.update(readback_worst_over_bitround=worst, readback_ok=worst <= 0.0,
                 forecast_finite=finite, dewpoint_max=float(np.nanmax(dd)),
                 output_only_nan_at_td0=bool(np.isnan(tp[:, 0]).all()),
                 output_only_finite_after=bool(np.isfinite(tp[:, 1:]).all()))

        # scored against the raw archive and the preprocessed store
        scores = {}
        for truth in (raw, store):
            t0 = time.perf_counter()
            scored = evaluate_store(str(out), str(truth), FIO_VARIABLES, FIO_LEADS,
                                    climatology=str(store / "climatology"), device="cuda")
            scores["raw" if truth == raw else "preprocessed"] = {
                "seconds": time.perf_counter() - t0, "scores": scored}
        rmse_keys = [f"{v}_h{lv}@{h}h" for v, lv in FIO_VARIABLES for h in FIO_LEADS]
        r["evaluate"] = scores
        r["evaluate_finite"] = all(k in sc["scores"] and np.isfinite(sc["scores"][k])
                                   for sc in scores.values() for k in rmse_keys)
        r["ok"] = (r["codecs"] == ["zstd"] and r["readback_ok"] and finite
                   and r["dewpoint_max"] <= 30.0 and r["output_only_nan_at_td0"]
                   and r["output_only_finite_after"] and launches == expected
                   and len(ds) == inits and stats["samples"] == inits
                   and stats["steps"] == STEPS * inits and r["evaluate_finite"]
                   and r["params_as_model"])
        res[key] = r
        res["ok"] = res["ok"] and r["ok"]
    return res


def run_export(card: str, fio_root: Path, prepared) -> dict:
    """``[export]``: the serving artifact on the card.  At 5.625°
    ``python -m paradis_torch.cli.export`` (at its default ``--device
    cuda``, in the process ``prepare_export`` started before
    ``[train-remat]``) turns ``[forecast-io]``'s checkpoint of the seeded
    fp32 flagship into an artifact (``forward.pt2``, the scanned
    ``rollout.pt2``, ``params.npz``) for 40 steps on that phase's store;
    ``paradis_torch.tools.bench_artifact --artifact`` loads it
    (``load_artifact``) and runs three ways, 40 steps each, in alternating
    turns: the artifact's rollout, its forward a step at a time, and
    ``make_forecast_rollout`` in process with the artifact's weights.  At
    1.40625° with ``compute.interp_band_rad`` the same process exported the
    seeded flagship's forward program alone (``export_hr_forward``); the
    bench loads it and runs it a step at a time and in
    process, ``EXPORT_HR_STEPS`` steps, each called once.  Gates: #1
    launched 8 × 40 times by one call of each way at 5.625° (8 a call of
    ``forward.pt2``), #5 8 × ``EXPORT_HR_STEPS`` at 1.40625°, and no other
    interpolation kernel; each artifact way within
    ``EXPORT_TOL`` of the largest |output| of the in-process rollout; the
    band plan in the 1.40625° graph and none in the 5.625° one."""
    import math

    from paradis_torch.tools import bench_artifact

    res = {"ok": True}
    art = fio_root / "artifact32"
    t0 = time.perf_counter()
    # the artifacts were made in their own process, started before
    # [train-remat] (prepare_export); what is left of it is the wait
    done = wait_ready(fio_root / EXPORT_READY, prepared, "the artifacts")
    res["export_wait_s"] = time.perf_counter() - t0
    if done["returncode"] != 0 or f"serving artifact written: {art}" not in done["stdout"]:
        raise SystemExit(f"cli.export failed ({done['returncode']}): {done['stderr']}")
    for key, grid, steps, argv, kernel in (
            (f"{NLAT}x{NLON}", (NLAT, NLON), STEPS,
             ["--artifact", str(art), "--repeats", "1"], "interp_fwd"),
            (f"{HR[0]}x{HR[1]}", HR, EXPORT_HR_STEPS,
             ["--artifact", str(fio_root / f"artifact{HR[0]}"), "--repeats", "0",
              "--ways", "steploop,inprocess"], "interp_band_fwd")):
        t0 = time.perf_counter()
        r = bench_artifact.main(argv)
        r["seconds"] = time.perf_counter() - t0
        r["prepared_export_s"] = done["cli_export_s" if kernel == "interp_fwd" else
                                      "hr_export_s"]
        if key == f"{NLAT}x{NLON}":
            r["cli_export_s"] = done["cli_export_s"]
        want = {kernel: 8 * steps}
        r["ok"] = (all(n == want for n in r["launches_per_call"].values())
                   and all(gap <= EXPORT_TOL * r["max_abs_out"]
                           for gap in r["max_abs_gap"].values())
                   and math.isfinite(r["max_abs_out"])
                   and r["grid"] == list(grid) and r["steps"] == steps
                   and len(r["traced"]["interp_ops"]) == 1
                   and (r["traced"]["interp_ops"][0]["band_plan"] is not None)
                   == (kernel == "interp_band_fwd"))
        res[key] = r
        res["ok"] = res["ok"] and r["ok"]
    return res


def check_advection_impls(card: str) -> dict:
    """One fp32 forecast step of the seeded 5.625° flagship built under each
    ``compute.advection_impl`` value.  ``pallas`` and ``auto_train``: bitwise
    ``auto``'s output with its launch counts.  ``gather``: finite, no
    interpolation kernel launched; the gather formulation index-clamps a tap
    outside the padded field where the kernels drop it, so on each layer's
    inputs of ``auto``'s step (recorded) it is held against the plain
    version where every tap of a position is inside (``KERNEL_TOL``), and
    the whole step against ``auto``'s within ``STEP_TOL`` when no tap of any
    layer leaves the field (else that gap is reported, not gated)."""
    import numpy as np
    import torch

    from paradis_torch.config import load_config
    from paradis_torch.ops.advection import AUTO_ALIASES
    from paradis_torch.ops.interp import interp_gather, interp_plain, tap_weights

    rng = np.random.default_rng(0)
    x = None
    outs, counts, captured = {}, {}, []
    for impl in ("auto", *AUTO_ALIASES, "gather"):
        cfg = load_config(overrides=[f"compute.advection_impl={impl}",
                                     "compute.use_amp=false"])
        d = flagship_dims(cfg)
        if x is None:
            x = torch.tensor(rng.normal(size=(1, NLAT, NLON, d["input_dim"])),
                             dtype=torch.float32, device="cuda")
        model, _ = flagship(cfg, (NLAT, NLON), "cuda", dtype=None)
        reset_counts()
        with torch.inference_mode(), (recording_fwd(captured, len(model.layers))
                                      if impl == "auto" else contextlib.nullcontext()):
            outs[impl] = model(x).float()
        torch.cuda.synchronize()
        counts[impl] = launch_counts()
        del model
    auto = outs["auto"]
    res = {"card": card, "launches": counts,
           "aliases_bitwise_auto": {i: bool(torch.equal(outs[i], auto)) for i in AUTO_ALIASES}}
    atol, rtol = KERNEL_TOL["float32"]
    worst, outside, total = 0.0, 0, 0
    for field, py, px, mode in captured:
        field, py, px = field.cuda(), py.cuda(), px.cuda()
        R, C = field.shape[1:3]
        inside = torch.ones_like(py, dtype=torch.bool)
        for pos, size in ((py, R), (px, C)):
            i0, offsets, _ = tap_weights(pos, mode)
            inside &= (i0 + offsets[0] >= 0) & (i0 + offsets[-1] <= size - 1)
        outside += int((~inside).sum())
        total += inside.numel()
        ref, got = interp_plain(field, py, px, mode), interp_gather(field, py, px, mode)
        over = ((got - ref).abs() - (atol + rtol * ref.abs()))[inside]
        worst = max(worst, float(over.max()) if over.numel() else 0.0)
    gap = float((outs["gather"] - auto).abs().max())
    limit = STEP_TOL["float32"] * float(auto.abs().max())
    res.update(gather_finite=bool(torch.isfinite(outs["gather"]).all()),
               gather_layers_recorded=len(captured),
               gather_positions_with_a_tap_outside=outside, gather_positions=total,
               gather_layer_worst_over_limit_inside=worst,
               gather_step_max_abs_diff_vs_auto=gap, gather_step_limit=limit,
               gather_step_gated=outside == 0)
    res["ok"] = (all(res["aliases_bitwise_auto"].values())
                 and all(counts[i] == counts["auto"] for i in AUTO_ALIASES)
                 and counts["auto"] == expected_launches(8, 0, False, 0)
                 and counts["gather"] == [0] * 6 and res["gather_finite"]
                 and len(captured) == 8 and worst <= 0.0 and (outside > 0 or gap <= limit))
    return res


@contextlib.contextmanager
def counting_steps(record: list):
    """``paradis_torch.train.loop.make_train_step`` wrapped for the block,
    under ``torch.cuda.set_sync_debug_mode("warn")``: for each train-step
    call, the synchronizing CUDA operations (thread, ``file:line``) made
    inside it and those made since the previous call returned (the loop's
    own, at its sync points).  ``record`` gets one dict a call and, at the
    end, the operations after the last call."""
    import threading
    import warnings

    import torch

    from paradis_torch.train import loop

    make = loop.make_train_step
    syncs: list = []
    last = [0]

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            syncs.append((threading.current_thread().name, f"{Path(filename).name}:{lineno}"))

    def wrapped_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def counted(*a, **k):
            n0 = len(syncs)
            out = step(*a, **k)
            record.append({"before": syncs[last[0]:n0], "inside": syncs[n0:]})
            last[0] = len(syncs)
            return out

        return counted

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        loop.make_train_step = wrapped_make
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
            loop.make_train_step = make
            record.append({"after": syncs[last[0]:]})


@contextlib.contextmanager
def timing_saves(store: list):
    """``CheckpointManager._save`` timed for the block (host clock; a save
    copies the state to the host, which waits for the device): ``store``
    gets ``(checkpoint directory, seconds)`` a save."""
    from paradis_torch.train.checkpoint import CheckpointManager

    save = CheckpointManager._save

    def timed(self, path, state, with_params=True):
        t0 = time.perf_counter()
        save(self, path, state, with_params)
        store.append((f"{path.parent.name}/{path.name}", time.perf_counter() - t0))

    CheckpointManager._save = timed
    try:
        yield
    finally:
        CheckpointManager._save = save


def read_metrics(path: Path) -> dict:
    """``metrics.csv`` as ``{name: {step: value}}`` (the last value a step)."""
    import csv

    out: dict = {}
    with open(path) as f:
        for step, name, value in list(csv.reader(f))[1:]:
            out.setdefault(name, {})[int(step)] = float(value)
    return out


def trace_device_ms(path: Path) -> float:
    """Device time in a ``torch.profiler`` chrome trace: kernels, copies and
    sets (their ``dur``, microseconds)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return sum(e.get("dur", 0) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3


def loop_in_turns(overrides: list, log_dir: Path) -> dict:
    """The 5.625° train step of one ``Trainer`` fed in turns by its loader
    ("loader"), by one batch kept on the card ("cached"), and by its loader
    with the native host library on one thread ("capped"; it runs on
    ``os.cpu_count()`` threads otherwise).  Each step does what
    ``Trainer.fit`` does at ``sync_every_n_steps=1``: the learning rate, the
    step, ``float(loss)`` and ``float(grad_norm)``; not its logging.  Wall
    seconds a step on the host clock, the first step of each turn left out
    (it waits for the loader's first batch).  ``LOOP_ROUNDS`` rounds of one
    turn a mode, the order rotated each round; the host's rate drifts within
    a call by more than the loader's cost, so each round's ratios (its
    loader's and capped turn's median step against its cached turn's)
    compare the modes, and their quartiles say whether the cost is
    resolved."""
    import itertools

    import numpy as np

    from paradis_torch.config import load_config
    from paradis_torch.data import native
    from paradis_torch.train import set_learning_rate
    from paradis_torch.train.loop import Trainer

    trainer = Trainer(load_config(overrides=overrides), log_dir=str(log_dir), device="cuda")
    num_common = trainer.train_ds.num_common_features
    cached = next(iter(trainer.train_loader))
    threads = native.default_threads
    rounds, losses, k = [], [], 0
    for r in range(LOOP_ROUNDS):
        order = LOOP_MODES[r % len(LOOP_MODES):] + LOOP_MODES[:r % len(LOOP_MODES)]
        step_s: dict = {}
        for mode in order:
            batches = itertools.repeat(cached) if mode == "cached" else iter(trainer.train_loader)
            if mode == "capped":
                native.default_threads = lambda: 1
            times = []
            try:
                t0 = time.perf_counter()
                for i, batch in zip(range(LOOP_TURN_STEPS), batches):
                    set_learning_rate(trainer.optimizer, trainer.schedule(k))
                    m = trainer.train_step(trainer.state, batch, num_common)
                    losses.append(float(m["loss"]))
                    float(m["grad_norm"])
                    k += 1
                    t1 = time.perf_counter()
                    if i:
                        times.append(t1 - t0)
                    t0 = t1
            finally:
                native.default_threads = threads
                if hasattr(batches, "close"):
                    batches.close()
            step_s[mode] = times
        rounds.append({"order": list(order), "step_s": step_s})
    trainer.metrics.close()

    def ratios(mode):
        return [float(np.median(r["step_s"]["cached"]) / np.median(r["step_s"][mode]))
                for r in rounds]

    res = {"modes": list(LOOP_MODES), "rounds": rounds, "steps_a_turn": LOOP_TURN_STEPS,
           "native_threads": threads(),
           "samples_per_s": {mode: 1.0 / float(np.median([t for r in rounds
                                                          for t in r["step_s"][mode]]))
                             for mode in LOOP_MODES}}
    for mode in ("loader", "capped"):
        res[f"{mode}_over_cached_by_round"] = ratios(mode)
        res[f"{mode}_over_cached_quartiles"] = [float(q) for q in
                                                np.percentile(ratios(mode), [25, 50, 75])]
    res["ok"] = (all(len(t) == LOOP_TURN_STEPS - 1 for r in rounds for t in r["step_s"].values())
                 and len(losses) == LOOP_TURN_STEPS * len(LOOP_MODES) * LOOP_ROUNDS
                 and all(np.isfinite(losses)))
    return res


def run_train_loop(card: str, root: Path, stores: dict, device_rates: dict) -> dict:
    """``python -m paradis_torch.cli.train`` (its ``main``) on the card at
    the flagship's full width, fed by the port's pipeline from the [data]
    stores.

    1.40625° in the bf16 train configuration (``interp_band_rad=0.3``,
    gradient checkpointing): ``LOOP_STEPS`` steps logged every step,
    validation on 1 batch and a step checkpoint every ``LOOP_EVERY``, the
    profiler window of ``LOOP_PROFILE``, the synchronizing operations counted
    a step (``counting_steps``); the metric names of the JAX loop, the JAX
    checkpoint layout, #5 and #6 16 and 8 times a step (and #5 8 times a
    validation batch), then ``init.restart`` from that run's checkpoints for
    ``LOOP_RESUME_STEPS`` more.  Then ``SYNC_STEPS`` steps at
    ``sync_every_n_steps=4`` (logging every 4, no checkpoint): the steps
    between sync points must make no synchronizing operation.  Then the
    5.625° loop, ``LOOP_LR_STEPS`` steps through #1 and #2, and its step fed
    in turns (``loop_in_turns``).  Rates: samples/s
    from ``metrics.csv`` (``samples_per_sec``: a step's wall time from the
    previous sync point, so a step after a validation, a checkpoint or the
    profiler's start or stop also pays for them), median over the other steps
    after the first two, beside the device-resident rate of [train] in this
    call (``device_rates``)."""
    import gc

    import numpy as np
    import torch

    from paradis_torch.cli import train as train_cli

    hr_store, lr_store = stores[f"{HR[0]}x{HR[1]}"]["path"], stores[f"{NLAT}x{NLON}"]["path"]
    logs = root / "logs"
    expected_names = {"model/num_parameters", "train_loss", "lr", "dt", "samples_per_sec",
                      "grad_norm", "forecast_steps", "host_rss_mb", "jit_cache_entries",
                      "val_loss", "geopotential_h500"}

    saves: list = []

    def main(args, record=None) -> tuple[dict, list, float]:
        reset_counts()
        t0 = time.perf_counter()
        with (counting_steps(record) if record is not None else contextlib.nullcontext(),
              timing_saves(saves)):
            result = train_cli.main(args)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        gc.collect()
        torch.cuda.empty_cache()
        return result, counts, seconds

    def rate(metrics: dict, skip: set) -> float:
        steps = [s for s in metrics["samples_per_sec"] if s > 2 and s not in skip]
        return float(np.median([metrics["samples_per_sec"][s] for s in steps]))

    common = [f"training.log_dir={logs}", *LOOP_DATES]
    hr_args = ["--device", "cuda", f"dataset.root_dir={hr_store}", *common,
               *HR_TRAIN_OVERRIDES, "training.experiment_name=hr", "training.log_every_n_steps=1",
               f"training.validation_dataset.validation_every_n_steps={LOOP_EVERY}",
               f"training.checkpointing.step_every={LOOP_EVERY}",
               "training.profiler.enabled=true", f"training.profiler.start_step={LOOP_PROFILE[0]}",
               f"training.profiler.num_steps={LOOP_PROFILE[1]}"]
    record: list = []
    result, counts, seconds = main(hr_args + [f"training.max_steps={LOOP_STEPS}"], record)
    exp = logs / "hr"
    metrics = read_metrics(exp / "metrics.csv")
    n_val = len(metrics.get("val_loss", {}))
    ckpt = exp / "checkpoints"
    layout = {rel: (ckpt / rel).is_file() for rel in (
        "last.json", f"steps/{LOOP_EVERY:08d}/state.pt", f"steps/{2 * LOOP_EVERY:08d}/state.pt",
        "epochs/0001/state.pt", "epochs/0001/params.pt", "best/best/state.pt",
        "best/best/params.pt", "best/metric.json")}
    # a step's wall time includes what the previous sync point did after
    # its loss: the profiler's start (step 2) and stop and export (step 4),
    # a validation and checkpoint (steps 4 and 8); steps 3-4 are traced
    traced = set(range(LOOP_PROFILE[0] + 1, LOOP_PROFILE[0] + LOOP_PROFILE[1] + 1))
    paid = {s + 1 for s in range(LOOP_EVERY, LOOP_STEPS + 1, LOOP_EVERY)} | {
        LOOP_PROFILE[0] + 1, LOOP_PROFILE[0] + LOOP_PROFILE[1] + 1}
    clean = sorted(set(range(3, LOOP_STEPS + 1)) - traced - paid)
    wall_ms = float(np.median([metrics["dt"][s] for s in clean])) * 1e3
    device_ms = trace_device_ms(exp / "profile" / "trace.json") / LOOP_PROFILE[1]
    expected = expected_launches(16 * LOOP_STEPS + 8 * n_val, 8 * LOOP_STEPS, True, 0)
    hr_saves = list(saves)
    hr = {
        "grid": list(HR), "steps": result["steps"], "seconds": seconds,
        "train_loss": [metrics["train_loss"][s] for s in sorted(metrics["train_loss"])],
        "val_loss": metrics.get("val_loss"), "metric_names": sorted(metrics),
        "missing_names": sorted(expected_names - set(metrics)),
        "checkpoint_layout": layout, "launches": counts, "expected_launches": expected,
        "validation_batches": n_val,
        "step_s": [metrics["dt"][s] for s in sorted(metrics["dt"])],
        "clean_steps": clean, "loop_samples_per_s": rate(metrics, traced | paid),
        "device_resident_samples_per_s": device_rates["hr"],
        "profile_device_ms_per_step": device_ms, "busy_share": device_ms / wall_ms,
        "checkpoint_save_s": hr_saves,
        "syncs_inside_step": [len(r["inside"]) for r in record if "inside" in r],
        "syncs_in_loop_after_step": [len(r["before"]) for r in record if "before" in r][1:],
        "sync_sites": sorted({site for r in record for k in ("inside", "before", "after")
                              for _, site in r.get(k, [])}),
        "sync_threads": sorted({t for r in record for k in ("inside", "before", "after")
                                for t, _ in r.get(k, [])}),
    }
    hr["ok"] = (result["steps"] == LOOP_STEPS and all(np.isfinite(hr["train_loss"]))
                and not hr["missing_names"] and all(layout.values()) and counts == expected)

    # resume from the run's own checkpoints (the root: last.json)
    record_r: list = []
    res_r, counts_r, seconds_r = main(hr_args + [
        f"training.max_steps={LOOP_STEPS + LOOP_RESUME_STEPS}", "init.restart=true",
        f"init.checkpoint_path={ckpt}"], record_r)
    after = read_metrics(exp / "metrics.csv")
    resumed_steps = sorted(s for s in after["train_loss"] if s > LOOP_STEPS)
    hr["resume"] = {"steps": res_r["steps"], "seconds": seconds_r, "logged_steps": resumed_steps,
                    "train_loss": [after["train_loss"][s] for s in resumed_steps],
                    "launched_steps": len([r for r in record_r if "inside" in r]),
                    "launches": counts_r}
    hr["resume"]["ok"] = (res_r["steps"] == LOOP_STEPS + LOOP_RESUME_STEPS
                          and resumed_steps == list(range(LOOP_STEPS + 1,
                                                          LOOP_STEPS + LOOP_RESUME_STEPS + 1))
                          and hr["resume"]["launched_steps"] == LOOP_RESUME_STEPS
                          and all(np.isfinite(hr["resume"]["train_loss"])))

    # sync_every_n_steps=4: no synchronizing operation between sync points
    record_s: list = []
    res_s, _, seconds_s = main(["--device", "cuda", f"dataset.root_dir={hr_store}", *common,
                                *HR_TRAIN_OVERRIDES, "training.experiment_name=hr-sync4",
                                f"training.max_steps={SYNC_STEPS}",
                                "training.sync_every_n_steps=4", "training.log_every_n_steps=4",
                                "training.checkpointing.enabled=false"], record_s)
    inside = [len(r["inside"]) for r in record_s if "inside" in r]
    loop_after = [len(r["before"]) for r in record_s if "before" in r][1:] + [
        len(record_s[-1]["after"])]
    sync_points = [s for s in range(1, SYNC_STEPS + 1)
                   if s % 4 == 0 or s <= 1 or s >= SYNC_STEPS]
    hr["sync4"] = {"steps": res_s["steps"], "seconds": seconds_s, "syncs_inside_step": inside,
                   "syncs_in_loop_after_step": loop_after, "sync_points": sync_points,
                   "sync_sites": sorted({site for r in record_s
                                         for k in ("inside", "before", "after")
                                         for _, site in r.get(k, [])})}
    hr["sync4"]["ok"] = (res_s["steps"] == SYNC_STEPS and not any(inside)
                         and not any(n for s, n in enumerate(loop_after, 1)
                                     if s not in sync_points))

    # the 5.625° loop: #1 and #2, a host-bound step
    res_l, counts_l, seconds_l = main(["--device", "cuda", f"dataset.root_dir={lr_store}",
                                       *common, *TRAIN_OVERRIDES,
                                       "training.experiment_name=lr",
                                       "training.log_every_n_steps=1",
                                       f"training.max_steps={LOOP_LR_STEPS}"])
    lm = read_metrics(logs / "lr" / "metrics.csv")
    n_val_l = len(lm.get("val_loss", {}))
    expected_l = expected_launches(8 * LOOP_LR_STEPS + 8 * n_val_l, 8 * LOOP_LR_STEPS, False, 0)
    lr = {"grid": [NLAT, NLON], "steps": res_l["steps"], "seconds": seconds_l,
          "train_loss": [lm["train_loss"][s] for s in sorted(lm["train_loss"])],
          "step_s": [lm["dt"][s] for s in sorted(lm["dt"])],
          "loop_samples_per_s": rate(lm, set()),
          "device_resident_samples_per_s": device_rates["lr"],
          "launches": counts_l, "expected_launches": expected_l}
    lr["turns"] = loop_in_turns([f"dataset.root_dir={lr_store}", *common, *TRAIN_OVERRIDES,
                                 f"training.max_steps="
                                 f"{LOOP_TURN_STEPS * len(LOOP_MODES) * LOOP_ROUNDS}"],
                                logs / "lr-turns")
    lr["ok"] = (res_l["steps"] == LOOP_LR_STEPS and all(np.isfinite(lr["train_loss"]))
                and counts_l == expected_l and not (expected_names - set(lm)
                                                    - {"geopotential_h500", "val_loss"})
                and lr["turns"]["ok"])
    return {"card": card, "hr": hr, "lr": lr,
            "ok": hr["ok"] and hr["resume"]["ok"] and hr["sync4"]["ok"] and lr["ok"]}


def run_bench_model(card: str) -> dict:
    """``[bench-model]``: ``paradis_torch.tools.bench_model`` at its defaults
    but ``BENCH_MODEL_REPEATS``, in this process (the kernels already built).  Gates: every row's ms
    positive, #1 8 times a ``pallas`` ``fwd`` call, #1 and #2 8 times each a
    ``pallas`` ``bwd`` call, neither in an ``xla`` row."""
    from paradis_torch.tools import bench_model

    res = bench_model.main(["--repeats", str(BENCH_MODEL_REPEATS)])
    layers = 8
    want = {"xla_fwd": {"interp_fwd": 0, "interp_bwd": 0},
            "xla_bwd": {"interp_fwd": 0, "interp_bwd": 0},
            "pallas_fwd": {"interp_fwd": layers, "interp_bwd": 0},
            "pallas_bwd": {"interp_fwd": layers, "interp_bwd": layers}}
    res["ok"] = (all(res[k] > 0 for k in want)
                 and {k: res["rows"][k]["launches_per_call"] for k in want} == want
                 and res["grid"] == [NLAT, NLON])
    return res


def run_profile_live(card: str, lr_store: str) -> dict:
    """``[profile-live]``: ``tools/profile_live`` on [data]'s 5.625° store at
    the flagship's full width (``PROFILE_LIVE_ARGS``).  Gates: its steps, the
    JAX script's keys, a finite loss, #1 and #2 8 times a step."""
    import numpy as np

    from paradis_torch.tools import profile_live

    reset_counts()
    res = profile_live.main(["--store", lr_store, *PROFILE_LIVE_ARGS])
    steps = int(PROFILE_LIVE_ARGS[PROFILE_LIVE_ARGS.index("--steps") + 1])
    res.update(card=card, launches=launch_counts(),
               expected_launches=expected_launches(8 * steps, 8 * steps, False, 0))
    res["ok"] = (res["steps"] == steps - 1 and np.isfinite(res["loss"])
                 and set(res["main_loop_ms_per_step"]) == {"queue_wait", "dispatch",
                                                           "metric_fetch", "other"}
                 and res["launches"] == res["expected_launches"])
    return res


def run_convergence(card: str, tool: str) -> dict:
    """``[ns-convergence]`` / ``[lq-convergence]``: ``tools/ns_convergence``
    (one seed) or ``tools/lq_convergence`` for ``CONVERGENCE_STEPS`` steps of
    their toy model (2 layers) on their 8 × 16 store, on the card.  Gates:
    finite losses, #1 and #2 2 times a step of each of the two runs."""
    import numpy as np

    from paradis_torch.tools import lq_convergence, ns_convergence

    reset_counts()
    t0 = time.perf_counter()
    if tool == "ns":
        recs = ns_convergence.main(["--steps", str(CONVERGENCE_STEPS), "--seeds", "1"])
        res = dict(recs[0])
        losses = res["losses_5"] + res["losses_3"]
    else:
        res = lq_convergence.main(["--steps", str(CONVERGENCE_STEPS)])
        losses = res["losses_a"] + res["losses_b"]
    n = 2 * 2 * CONVERGENCE_STEPS
    res.update(card=card, seconds=time.perf_counter() - t0, launches=launch_counts(),
               expected_launches=expected_launches(n, n, False, 0))
    res["ok"] = (len(losses) == 2 * CONVERGENCE_STEPS and bool(np.isfinite(losses).all())
                 and res["launches"] == res["expected_launches"])
    return res


def report_host_tools(tools: dict, card: str) -> None:
    """``[bench-pipeline]`` and ``[roofline]``: the records ``host_tools``
    made; fails on a failed gate: bench_pipeline's samples through both
    paths, roofline's custom ops counted (not 0) and its FlopCounterMode
    total within 10% below to 1% above the analytic sum."""
    for key, rec in tools.items():
        if key.startswith("bench_pipeline"):
            ok = (rec["host"]["samples"] > 0 and rec["with_place"] is not None
                  and rec["with_place"]["samples"] == rec["host"]["samples"])
            log(f"[bench-pipeline] {json.dumps(rec)}")
            log(f"[bench-pipeline] {key.split()[1]}: host path {rec['host']['samples_per_sec']:.2f} "
                f"samples/s, with place to the card {rec['with_place']['samples_per_sec']:.2f} "
                f"({rec['host']['samples']} samples, [data]'s store) on {rec['card']}")
        else:
            cost = rec["cost"]
            ratio = cost["flops"] / rec["analytic_flops"]
            ok = (cost["flops_by_op"].get("paradis.interp", 0) > 0
                  and cost["flops_by_op"].get("paradis.interp_bwd", 0) > 0
                  and 0.9 <= ratio <= 1.01)
            log(f"[roofline] {json.dumps(rec, default=float)}")
            log(f"[roofline] {key.split()[1]}: FlopCounterMode {cost['flops'] / 1e9:.1f} GFLOP "
                f"a train step against the analytic {rec['analytic_flops'] / 1e9:.1f} "
                f"({ratio:.4f}), eager operators' bytes {cost['bytes'] / 2 ** 30:.2f} GiB; "
                + ", ".join(f"{k} {c['ms']:.4g} ms ({c['bound_by']})"
                            for k, c in rec["components"].items())
                + f" at the peaks of {card}")
        if not ok:
            raise SystemExit(f"{key} failed its checks: {rec}")


def rank_worker(argv: list[str]) -> int:
    """``--worker {train,forecast} OUT ARGS... [--then [KIND] OUT ARGS...]``:
    one rank of a launch that ``torch.distributed.run`` started: for each run
    in turn the entry point's ``main(ARGS)`` (``cli.train`` or
    ``cli.forecast``: the launch's kind, or the run's own after ``--then``),
    then the rank's launch counts of that run, the sharded checkpoint files
    it wrote and the entry point's result into ``OUT.rank<RANK>.json``.  The runs of one launch share its process
    group: it is shut down after the last (a launch's process start, ~16 s,
    is paid once)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from paradis_torch import distributed
    from paradis_torch.cli import forecast as forecast_cli
    from paradis_torch.cli import train as train_cli

    kind, runs = argv[0], []
    for arg in argv[1:]:
        if arg == "--then" or not runs:
            runs.append([kind] if arg == "--then" else [kind, arg])
        elif len(runs[-1]) == 1 and arg in ("train", "forecast"):
            runs[-1][0] = arg
        else:
            runs[-1].append(arg)
    from paradis_torch.train import checkpoint

    written = []  # the files this rank writes through the checkpoint module
    write_file = checkpoint.write_file

    def recording_write(path, obj):
        written.append(Path(path).name)
        write_file(path, obj)

    checkpoint.write_file = recording_write
    shutdown = distributed.shutdown_distributed
    for i, (run_kind, out, *args) in enumerate(runs):
        cli = train_cli if run_kind == "train" else forecast_cli
        distributed.shutdown_distributed = shutdown if i == len(runs) - 1 else (lambda: None)
        reset_counts()
        written.clear()
        t0 = time.perf_counter()
        result = cli.main(args)
        rank = int(os.environ.get("RANK", "0"))
        out = Path(out)
        out.with_name(f"{out.name}.rank{rank}.json").write_text(json.dumps(
            {"rank": rank, "seconds": time.perf_counter() - t0, "launches": launch_counts(),
             "shards_written": sorted({n for n in written if n.startswith("shard_p")}),
             "result": result}, default=float))
    return 0


def free_port() -> int:
    """A free port for a launch's store, drawn at random below the ephemeral
    range: a port that ``bind(0)`` hands out and frees could be taken by a
    socket that another launch's gloo binds to port 0 before this launch's
    rank 0 binds its store, which would hang the launch."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.SystemRandom()
    while True:
        port = rng.randrange(10000, max(low, 10001))
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def torchrun(n: int, kind: str, runs: list, timeout: int = 400):
    """Start ``python -m torch.distributed.run --nproc-per-node n`` of this
    script's ``--worker`` mode for ``runs``, ``[(OUT, ARGS[, KIND]), ...]``
    in turn (``kind`` where a run names none); returns the function that
    waits for it and returns the launch's wall seconds and, for each run,
    each rank's record.  A rank's failure fails the phase (the launcher then
    stops the others and exits non-zero)."""
    port = free_port()
    argv = []
    for i, (out, args, *run_kind) in enumerate(runs):
        argv += (["--then", *run_kind] if i else []) + [str(out), *args]
    if runs and len(runs[0]) > 2:
        kind = runs[0][2]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
         "--master-addr", "127.0.0.1", "--master-port", str(port), str(Path(__file__).resolve()),
         "--worker", kind, *argv],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)

    def wait() -> dict:
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f"{n}-rank {kind} failed ({proc.returncode}): "
                             f"{stdout[-2000:]}\n{stderr[-4000:]}")
        return {"seconds": seconds,
                "runs": [[json.loads(out.with_name(f"{out.name}.rank{r}.json").read_text())
                          for r in range(n)] for out, *_ in runs]}

    return wait


def run_multi_gpu(card: str, lr_store: Path, fio_root: Path, root: Path) -> dict:
    """``[multi-gpu]``: the multi-rank paths on the one card, in three
    launches (see the module docstring, (a)-(d)): (a), (c) and (c)'s resume
    in one launch of 2 gloo ranks; beside it (b), then (d)."""
    import numpy as np

    from paradis_torch.data import zarrlite

    res = {"card": card, "ok": True}
    common = ["--device", "cuda", f"dataset.root_dir={lr_store}", *LOOP_DATES,
              *TRAIN_OVERRIDES, "training.log_every_n_steps=1", f"training.log_dir={root}"]

    def train_runs(runs: list) -> list:
        return [(root / name, common + [f"training.experiment_name={name}", *args])
                for name, args in runs]

    def collect(name: str, ranks: list) -> dict:
        """A run's ranks' records, its metrics and files, and whether each
        rank launched #1 and #2 8 times a step (and #1 8 times a
        validation batch, its rows of it)."""
        run = {"ranks": ranks, "seconds": max(r["seconds"] for r in ranks)}
        exp = root / name
        m = read_metrics(exp / "metrics.csv")
        steps = sorted(m["train_loss"])
        n_val = len(m.get("val_loss", {}))
        run.update(losses=[m["train_loss"][s] for s in steps], steps=steps,
                   grad_norms=[m["grad_norm"][s] for s in steps], val_batches=n_val,
                   samples_per_s=float(np.median([m["samples_per_sec"][s] for s in steps[1:]])),
                   files=sorted(str(p.relative_to(exp)) for p in exp.rglob("*") if p.is_file()))
        taken = len(steps)
        run["launches_ok"] = all(r["launches"] == [8 * (taken + n_val), 8 * taken, 0, 0, 0, 0]
                                 for r in ranks)
        return run

    def close(a: list, b: list) -> float:
        return float(max(abs(x - y) / abs(y) for x, y in zip(a, b)))

    steps = f"training.max_steps={MG_STEPS}"
    # (c) FSDP on 2 samples (one global batch an epoch): 2k steps saving
    # after k, and a resume from it for k more (FSDP against the replicated
    # ranks on the same samples: tests/test_torch_multirank.py)
    k = MG_FSDP_K
    two = [f"training.max_steps={2 * k}", "compute.num_devices=2",
           "compute.dist_backend=gloo", "compute.fsdp=true",
           "training.dataset.end_date=2000-01-01T06:00:00",
           f"training.checkpointing.step_every={k}"]
    step_k = root / "fsdp" / "checkpoints" / "steps" / f"{k:08d}"
    # (a) two gloo ranks on the one card, batch 1 a rank, then (c) and its resume
    wait_a = torchrun(2, "train", train_runs([
        ("dp2", [steps, "compute.num_devices=2", "compute.dist_backend=gloo",
                 "compute.batch_size=1"]),
        ("fsdp", two),
        ("fsdp_resumed", [*two, "init.restart=true", f"init.checkpoint_path={step_k}"])]))
    # (b) one NCCL rank with batch 2, beside (a)
    wait_b = torchrun(1, "train", train_runs([
        ("nccl1", [steps, "compute.dist_backend=nccl", "compute.batch_size=2",
                   "training.checkpointing.enabled=false"])]))
    out = root / "fc2.zarr"
    try:
        b = wait_b()
        # (d) the forecast CLI on two gloo ranks against [forecast-io]'s
        # one-process store, beside the rest of (a) and (c)
        d = torchrun(2, "forecast", [(root / "fc2", [
            "--checkpoint-path", str(fio_root / f"fio_params{NLAT}.pt"), "--output-file",
            str(out), "--forecast-steps", str(STEPS), "--sampling-interval", FIO_INTERVAL,
            "--start-date", FIO_START, "--end-date", FIO_GRIDS[(NLAT, NLON)][1],
            "--batch-size", "1", "--write-every-n", str(FIO_WRITE_EVERY), "--device", "cuda",
            "--num-devices", "2", f"dataset.root_dir={fio_root / f'fio_store{NLAT}'}",
            "compute.dist_backend=gloo"])])()
    finally:
        a = wait_a()
    dp, full, resumed = (collect(name, ranks) for name, ranks in
                         zip(("dp2", "fsdp", "fsdp_resumed"), a["runs"]))
    one = collect("nccl1", b["runs"][0])
    res["launch_seconds"] = {"dp2, fsdp, fsdp_resumed": a["seconds"], "nccl1": b["seconds"],
                             "fc2": d["seconds"]}
    dp["loss_rel_gap"] = close(dp["losses"], one["losses"])
    # what one process writes in one epoch: only rank 0 wrote
    dp["files_as_one_process"] = dp["files"] == MG_RUN_FILES
    res["dp"], res["nccl"] = dp, one
    res["ok"] = (dp["launches_ok"] and one["launches_ok"] and dp["steps"] == one["steps"]
                 == list(range(1, MG_STEPS + 1)) and dp["loss_rel_gap"] <= MG_LOSS_RTOL
                 and dp["files_as_one_process"])

    shards = sorted(p.name for p in (step_k / "state_sharded").iterdir())
    resumed["loss_rel_gap"] = close(resumed["losses"], full["losses"][k:])
    res["fsdp"], res["fsdp_resumed"] = full, resumed
    res["ok"] = res["ok"] and (full["launches_ok"] and resumed["launches_ok"]
                               and shards == ["shard_p0.pt", "shard_p1.pt"]
                               and full["steps"] == list(range(1, 2 * k + 1))
                               and resumed["steps"] == list(range(k + 1, 2 * k + 1))
                               and resumed["loss_rel_gap"] <= MG_LOSS_RTOL)

    fa, fb = zarrlite.open_store(fio_root / f"fio_forecast{NLAT}.zarr"), zarrlite.open_store(out)
    unequal = sorted(name for name in fa.arrays()
                     if not np.array_equal(fa[name][...], fb[name][...], equal_nan=True))
    inits = FIO_GRIDS[(NLAT, NLON)][2]
    ranks = d["runs"][0]
    fc = {"seconds": d["seconds"], "ranks": ranks, "unequal_arrays": unequal,
          "arrays": len(list(fa.arrays())), "total": ranks[0]["result"]["total"],
          "launches": [r["launches"] for r in ranks]}
    res["forecast"] = fc
    res["ok"] = res["ok"] and (not unequal and sorted(fa.arrays()) == sorted(fb.arrays())
                               and fc["total"]["samples"] == inits
                               and all(r["launches"] == [8 * STEPS, 0, 0, 0, 0, 0]
                                       for r in ranks))
    return res


def start_spatial(lr_store: Path, fio_root: Path, root: Path):
    """``[spatial]``'s launch, started beside ``[multi-gpu]``'s: 2 gloo ranks
    sharing the card, (e) ``cli.train`` with ``compute.lat_devices=2`` and
    (f) with ``compute.spatial_devices=2`` on ``[data]``'s 5.625° store as
    ``[multi-gpu]``'s runs but with the global batch of 2 on each rank's
    block (the data size is 1), then (g) ``cli.forecast`` with
    ``compute.lat_devices=2`` on ``[forecast-io]``'s 1.40625° store and
    weights for ``SPATIAL_FC_STEPS`` steps; returns the wait."""
    common = ["--device", "cuda", f"dataset.root_dir={lr_store}", *LOOP_DATES,
              *TRAIN_OVERRIDES, "training.log_every_n_steps=1", f"training.log_dir={root}",
              f"training.max_steps={MG_STEPS}", "compute.batch_size=2",
              "compute.dist_backend=gloo", "training.checkpointing.enabled=false"]
    _, end_date, _, overrides = FIO_GRIDS[HR]
    return torchrun(2, "train", [
        (root / "lat2", [*common, "training.experiment_name=lat2", "compute.lat_devices=2"]),
        (root / "space2", [*common, "training.experiment_name=space2",
                           "compute.spatial_devices=2"]),
        (root / "fc_lat2", [
            "--checkpoint-path", str(fio_root / f"fio_params{HR[0]}.pt"), "--output-file",
            str(root / "fc_lat2.zarr"), "--forecast-steps", str(SPATIAL_FC_STEPS),
            "--sampling-interval", FIO_INTERVAL, "--start-date", FIO_START, "--end-date",
            end_date, "--batch-size", "1", "--write-every-n", str(FIO_WRITE_EVERY),
            "--device", "cuda", f"dataset.root_dir={fio_root / f'fio_store{HR[0]}'}",
            *overrides, "compute.lat_devices=2", "compute.dist_backend=gloo"], "forecast")])


def finish_spatial(wait, root: Path, one: dict, fio_root: Path, fio_hr: dict) -> dict:
    """``[spatial]``'s gates: each train run's losses within ``MG_LOSS_RTOL``
    of ``[multi-gpu]``'s one process with the batch of 2 (``one``), #1 and #2
    8 times a step on each rank (and #1 8 times a validation batch); the
    forecast's store within a BitRound(16) step plus ``SPATIAL_FC_TOL`` of
    each variable's largest value of ``[forecast-io]``'s one-process
    1.40625° store over the leads it holds, #1 (not #5: a block's positions
    take the unbanded kernel on the clamped rows) 8 times a step on each
    rank.  Step and rollout seconds beside the one process's."""
    import numpy as np

    from paradis_torch.data import zarrlite

    sp = wait()
    res = {"launch_seconds": sp["seconds"], "ok": True}
    one_dt = float(np.median([read_metrics(root.parent / "nccl1" / "metrics.csv")["dt"][s]
                              for s in one["steps"][1:]]))
    for name, ranks in zip(("lat2", "space2"), sp["runs"][:2]):
        m = read_metrics(root / name / "metrics.csv")
        steps = sorted(m["train_loss"])
        n_val = len(m.get("val_loss", {}))
        losses = [m["train_loss"][s] for s in steps]
        r = {"seconds": max(x["seconds"] for x in ranks), "steps": steps, "losses": losses,
             "loss_rel_gap": float(max(abs(a - b) / abs(b) for a, b in
                                       zip(losses, one["losses"]))),
             "launches": [x["launches"] for x in ranks],
             "step_s": float(np.median([m["dt"][s] for s in steps[1:]])), "one_step_s": one_dt}
        r["ok"] = (steps == one["steps"] and r["loss_rel_gap"] <= MG_LOSS_RTOL
                   and all(x["launches"] == [8 * (len(steps) + n_val), 8 * len(steps), 0, 0, 0, 0]
                           for x in ranks))
        res[name] = r
        res["ok"] = res["ok"] and r["ok"]
    ranks = sp["runs"][2]
    a = zarrlite.open_store(fio_root / f"fio_forecast{HR[0]}.zarr")
    b = zarrlite.open_store(root / "fc_lat2.zarr")
    gaps, within = {}, True
    for name in b.arrays():
        y = b[name][...]
        if y.ndim < 4:
            continue
        x = a[name][:, : y.shape[1]]
        ok = np.isfinite(x)
        within = within and bool((np.isfinite(y) == ok).all())
        top = float(np.abs(x[ok]).max())
        gaps[name] = float(np.abs(y[ok] - x[ok]).max() / top)
        within = within and bool((np.abs(y[ok] - x[ok])
                                  <= BITROUND_STEP * np.abs(x[ok]) + SPATIAL_FC_TOL * top).all())
    steps = SPATIAL_FC_STEPS
    fc = {"seconds": max(x["seconds"] for x in ranks), "gaps": gaps,
          "launches": [x["launches"] for x in ranks],
          "rollout_s_a_step": [x["result"]["rollout_s"] / steps for x in ranks],
          "one_device_s_a_step": 1.0 / fio_hr["forecast_steps_per_s_device"]}
    fc["ok"] = within and bool(gaps) and all(x["launches"] == [8 * steps, 0, 0, 0, 0, 0]
                                             for x in ranks)
    res["forecast"] = fc
    res["ok"] = res["ok"] and fc["ok"]
    return res


def run_spatial_fsdp(lr_store: Path, root: Path, one: dict, lat2: dict) -> dict:
    """``[spatial-fsdp]``: one launch of 4 gloo ranks sharing the card, after
    ``[spatial]``'s (not beside ``[multi-gpu]``: the host's cores), (h)
    ``cli.train`` with ``compute.fsdp=true compute.lat_devices=2`` (``data 2
    × lat 2``) on ``[data]``'s 5.625° store as ``[multi-gpu]``'s runs, the
    global batch of 2 (one row a data rank, its block on each lat rank),
    ``MG_STEPS`` steps and a sharded step checkpoint after ``MG_FSDP_K``.
    Gates: each step's loss within ``MG_LOSS_RTOL`` of ``[multi-gpu]``'s one
    process with the batch of 2 (``one``); #1 and #2 8 times a step on each
    rank (and #1 8 times a validation batch); the step checkpoint one shard
    a data rank, ``shard_p0`` and ``shard_p1``, written by the ranks of the
    lead spatial position (0 and 2) alone, its grid ``[2, 2, 1]``, and read
    back whole into the flagship (``load_params``: every parameter, each
    shape).  Seconds a step beside the replicated ``lat2`` run of
    ``[spatial]`` (``lat2``)."""
    import numpy as np

    from paradis_torch.config import load_config
    from paradis_torch.tools.flagship import flagship
    from paradis_torch.train.checkpoint import load_params
    from paradis_torch.train.sharded_ckpt import SHARD_DIR, read_sharded

    k = MG_FSDP_K
    wait = torchrun(4, "train", [(root / "fsdp_lat2", [
        "--device", "cuda", f"dataset.root_dir={lr_store}", *LOOP_DATES, *TRAIN_OVERRIDES,
        "training.log_every_n_steps=1", f"training.log_dir={root}",
        "training.experiment_name=fsdp_lat2", f"training.max_steps={MG_STEPS}",
        "compute.batch_size=1", "compute.dist_backend=gloo", "compute.fsdp=true",
        "compute.lat_devices=2", f"training.checkpointing.step_every={k}"])])
    run = wait()
    ranks = run["runs"][0]
    m = read_metrics(root / "fsdp_lat2" / "metrics.csv")
    steps = sorted(m["train_loss"])
    n_val = len(m.get("val_loss", {}))
    losses = [m["train_loss"][s] for s in steps]
    step_k = root / "fsdp_lat2" / "checkpoints" / "steps" / f"{k:08d}"
    shards = sorted(p.name for p in (step_k / SHARD_DIR).iterdir())
    saved = read_sharded(step_k / SHARD_DIR)
    model, _ = flagship(load_config(overrides=TRAIN_OVERRIDES), (NLAT, NLON), "cpu")
    t0 = time.perf_counter()
    load_params(step_k, model)
    r = {"launch_seconds": run["seconds"], "seconds": max(x["seconds"] for x in ranks),
         "steps": steps, "losses": losses,
         "loss_rel_gap": float(max(abs(a - b) / abs(b) for a, b in zip(losses, one["losses"]))),
         "launches": [x["launches"] for x in ranks],
         "shards": shards, "writers": [x["rank"] for x in ranks if x["shards_written"]],
         "shards_written": [x["shards_written"] for x in ranks], "grid": saved["grid"],
         "params_read": sum(v.numel() for v in saved["params"].values()),
         "load_params_s": time.perf_counter() - t0,
         "step_s": float(np.median([m["dt"][s] for s in steps[1:]])),
         "lat2_step_s": lat2["step_s"], "one_step_s": lat2["one_step_s"]}
    r["ok"] = (steps == one["steps"] and r["loss_rel_gap"] <= MG_LOSS_RTOL
               and all(x == [8 * (len(steps) + n_val), 8 * len(steps), 0, 0, 0, 0]
                       for x in r["launches"])
               and shards == ["shard_p0.pt", "shard_p1.pt"] and r["writers"] == [0, 2]
               and r["grid"] == [2, 2, 1] and saved["step"] == k
               and r["params_read"] == sum(p.numel() for p in model.parameters()))
    return r


def report_spatial_fsdp(r: dict, card: str) -> None:
    """``[spatial-fsdp]``'s lines; fails the phase on a failed gate."""
    log("[spatial-fsdp] " + json.dumps(r))
    if not r["ok"]:
        raise SystemExit(f"the FSDP run on a spatial grid failed its checks: {r}")
    log(f"[spatial-fsdp] fsdp data2 x lat2: 4 gloo ranks sharing the card, losses "
        f"{[round(v, 6) for v in r['losses']]}, gap to one process {r['loss_rel_gap']:.3g} "
        f"(limit {MG_LOSS_RTOL}), {r['step_s']:.3f} s a step against {r['lat2_step_s']:.3f} "
        f"replicated on lat 2 ([spatial]) and {r['one_step_s']:.3f} in one process; "
        f"launches #1/#2 a rank {[x[:2] for x in r['launches']]}; shards {r['shards']} "
        f"written by ranks {r['writers']}, {r['params_read']} parameters read back; "
        f"launch {r['launch_seconds']:.1f} s on {card}")


def report_spatial(sp: dict, card: str) -> None:
    """``[spatial]``'s lines; fails the phase on a failed gate."""
    log("[spatial] " + json.dumps(sp))
    if not sp["ok"]:
        raise SystemExit(f"the spatial runs failed their checks: {sp}")
    for key in ("lat2", "space2"):
        r = sp[key]
        log(f"[spatial] {key}: 2 gloo ranks sharing the card, losses "
            f"{[round(v, 6) for v in r['losses']]}, gap to one process {r['loss_rel_gap']:.3g} "
            f"(limit {MG_LOSS_RTOL}), {r['step_s']:.3f} s a step against {r['one_step_s']:.3f} "
            f"in one process, launches #1/#2 a rank {[x[:2] for x in r['launches']]} on {card}")
    fc = sp["forecast"]
    log(f"[spatial] forecast 1.40625 lat2: {SPATIAL_FC_STEPS} float32 steps, rollout "
        f"{[round(v, 3) for v in fc['rollout_s_a_step']]} s a step a rank against "
        f"{fc['one_device_s_a_step']:.3f} (one process, device-only), largest gap "
        f"{max(fc['gaps'].values()):.3g} of a variable's largest value, launches #1 a rank "
        f"{[x[0] for x in fc['launches']]}; launch {sp['launch_seconds']:.1f} s on {card}")


def report_bench_model(res: dict, card: str) -> None:
    """``[bench-model]``'s lines; fails the phase on a failed gate."""
    log("[bench-model] " + json.dumps(res))
    if not res["ok"]:
        raise SystemExit(f"the model benchmark failed its checks: {res}")
    log("[bench-model] " + ", ".join(
        f"{k} {res[k]:.3f} ms (first call {res['rows'][k]['first_call_s']:.2f} s)"
        for k in ("xla_fwd", "xla_bwd", "pallas_fwd", "pallas_bwd"))
        + f"; kernels built before: {res['kernels_built']}; bf16 {NLAT}x{NLON} batch 1 "
        f"on {card}")


def report_multi_gpu(mg: dict, card: str) -> None:
    """``[multi-gpu]``'s lines; fails the phase on a failed gate."""
    log("[multi-gpu] " + json.dumps(mg))
    if not mg["ok"]:
        raise SystemExit(f"the multi-rank runs failed their checks: {mg}")
    for key in ("dp", "nccl", "fsdp", "fsdp_resumed"):
        r = mg[key]
        log(f"[multi-gpu] {key}: {len(r['ranks'])} rank(s), {r['seconds']:.1f} s, losses "
            f"{[round(v, 6) for v in r['losses']]}, {r['samples_per_s']:.3f} samples/s, "
            f"launches a rank {[x['launches'][:2] for x in r['ranks']]} on {card}")
    log(f"[multi-gpu] launches: " + ", ".join(f"{k} {v:.1f} s"
                                             for k, v in mg["launch_seconds"].items())
        + f" on {card}")
    log(f"[multi-gpu] loss gaps (limit {MG_LOSS_RTOL}): gloo x2 against nccl x1 "
        f"{mg['dp']['loss_rel_gap']:.3g}, fsdp resumed {mg['fsdp_resumed']['loss_rel_gap']:.3g}; "
        f"forecast x2 {mg['forecast']['seconds']:.1f} s, "
        f"{mg['forecast']['total']['forecast_steps_per_s']:.3f} steps/s, unequal arrays "
        f"{mg['forecast']['unequal_arrays']} on {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from paradis_torch import _build

    # fp32 matmuls and convolutions in full fp32, as the reference states
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"[card] {card}")
    smoke_t0 = time.perf_counter()

    def phase_done(name: str) -> None:
        log(f"[time] {name} done at {time.perf_counter() - smoke_t0:.1f} s")

    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, devices {torch.cuda.device_count()}")
    log(f"[card] tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    report = _build.build()
    log(f"[build] {len(report)} source(s) in {time.perf_counter() - t0:.1f} s")
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")

    flag = (1, NLAT + 4, NLON + 4, 768, NLAT, NLON)   # bicubic pad 2: 36 × 68
    flag_bl = (1, NLAT + 2, NLON + 2, 768, NLAT, NLON)  # bilinear pad 1: 34 × 66
    tail = (1, 13, 22, 77, 9, 15)                     # P·V = 10395, no multiple of 256
    checks = []
    for dtype_name in ("float32", "bfloat16"):
        for mode, shape in (("bicubic", flag), ("bilinear", flag_bl)):
            checks.append(check_kernel(mode, dtype_name, shape, timed=True))
        for mode in ("bicubic", "bilinear"):
            checks.append(check_kernel(mode, dtype_name, tail, timed=False))
    for c in checks:
        log("[kernel] " + json.dumps(c))
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    phase_done("[kernel]")

    bwd_checks = []
    for dtype_name in ("float32", "bfloat16"):
        for mode, shape in (("bicubic", flag), ("bilinear", flag_bl)):
            bwd_checks.append(check_bwd_kernel(mode, dtype_name, shape, timed=True))
        for mode in ("bicubic", "bilinear"):
            bwd_checks.append(check_bwd_kernel(mode, dtype_name, tail, timed=False))
        bwd_checks.append(check_bwd_kernel("bilinear", dtype_name, flag_bl, timed=False,
                                           integer=True))
    for c in bwd_checks:
        log("[kernel-bwd] " + json.dumps(c))
    bad = [c for c in bwd_checks if not c["ok"]]
    if bad:
        raise SystemExit(f"backward kernel disagrees with its plain version: {bad}")
    phase_done("[kernel-bwd]")

    # the row-banded pair at the 1.40625° shapes, positions clamped to the
    # bound compute.interp_band_rad gives on that grid, and at an odd tail
    # shape where the band gate is on (bands of 8 rows over 16 padded rows)
    from paradis_torch.model.paradis import band_bound_pixels
    from paradis_torch.sphere.geometry import equiangular_lat_lon

    hr_px = band_bound_pixels(BAND_RAD, equiangular_lat_lon(*HR, include_poles=False)[0])
    hr = (1, HR[0] + 4, HR[1] + 4, 768, *HR)      # bicubic: 132 × 260
    hr_bl = (1, HR[0] + 2, HR[1] + 2, 768, *HR)   # bilinear: 130 × 258
    band_tail = {"bicubic": (1, 36, 19, 77, 32, 15), "bilinear": (1, 34, 17, 77, 32, 15)}
    band_checks, band_bwd_checks = [], []
    for dtype_name in ("float32", "bfloat16"):
        for mode, shape in (("bicubic", hr), ("bilinear", hr_bl)):
            band_checks.append(check_kernel(mode, dtype_name, shape, timed=True, band_px=hr_px))
            band_bwd_checks.append(check_bwd_kernel(mode, dtype_name, shape, timed=True,
                                                    band_px=hr_px))
        for mode, shape in band_tail.items():
            band_checks.append(check_kernel(mode, dtype_name, shape, timed=False, band_px=1.5))
            band_bwd_checks.append(check_bwd_kernel(mode, dtype_name, shape, timed=False,
                                                    band_px=1.5))
    for c in band_checks:
        log("[kernel-band] " + json.dumps(c))
    for c in band_bwd_checks:
        log("[kernel-band-bwd] " + json.dumps(c))
    bad = [c for c in band_checks + band_bwd_checks if not c["ok"]]
    if bad:
        raise SystemExit(f"banded kernel disagrees with its plain version or the unbanded "
                         f"kernel: {bad}")
    # the same shapes on rows that are not clamped: taps leave their band
    outside_checks = [check_band_outside(mode, dtype_name, shape, bound)
                      for dtype_name in ("float32", "bfloat16")
                      for mode, shape, bound in (("bicubic", hr, hr_px), ("bilinear", hr_bl, hr_px),
                                                 ("bicubic", band_tail["bicubic"], 1.5),
                                                 ("bilinear", band_tail["bilinear"], 1.5))]
    for c in outside_checks:
        log("[kernel-band-outside] " + json.dumps(c))
    bad = [c for c in outside_checks if not c["ok"]]
    if bad:
        raise SystemExit(f"banded kernel on unclamped rows disagrees with its plain version, "
                         f"or with the unbanded kernel where no tap leaves its band: {bad}")
    phase_done("[kernel-band*]")
    torch.cuda.empty_cache()

    # the row-chunked pair at the shapes of the two chunked paths, on random
    # positions and on departure-like ones (clamped to the bound
    # compute.interp_band_rad=0.3 gives on each grid), timed on the latter;
    # and an odd tail shape whose last chunk has 5 of its 8 rows
    lr_px = band_bound_pixels(BAND_RAD, equiangular_lat_lon(NLAT, NLON, include_poles=False)[0])
    chunk_checks, chunk_bwd_checks = [], []
    for dtype_name in ("float32", "bfloat16"):
        for mode, shape, rw, depart in (("bicubic", flag, CHUNK_RW, lr_px),
                                        ("bilinear", flag_bl, CHUNK_RW, lr_px),
                                        ("bicubic", hr, HR_CHUNK_RW, hr_px),
                                        ("bilinear", hr_bl, HR_CHUNK_RW, hr_px),
                                        ("bicubic", tail, CHUNK_RW, 1.5),
                                        ("bilinear", tail, CHUNK_RW, 1.5)):
            for depart_px in (None, depart):
                timed = depart_px is not None and shape != tail
                chunk_checks.append(check_kernel(mode, dtype_name, shape, timed, chunk_rw=rw,
                                                 depart_px=depart_px))
                chunk_bwd_checks.append(check_bwd_kernel(mode, dtype_name, shape, timed,
                                                         chunk_rw=rw, depart_px=depart_px))
    for c in chunk_checks:
        log("[kernel-chunk] " + json.dumps(c))
    for c in chunk_bwd_checks:
        log("[kernel-chunk-bwd] " + json.dumps(c))
    bad = [c for c in chunk_checks + chunk_bwd_checks if not c["ok"]]
    if bad:
        raise SystemExit(f"chunked kernel disagrees with its plain version or the unbanded "
                         f"kernel: {bad}")
    phase_done("[kernel-chunk*]")

    # the weight-generation pair at the microbenchmark's shapes and a tail
    from paradis_torch.tools import bench_interp

    # timed at the microbenchmark's shape in both modes; untimed at a tail
    # shape (10,395 elements, no multiple of 4) and on views one element into
    # their buffers (no 16-byte alignment: the scalar kernel)
    gen_checks = [check_gen(derivative, shape, timed=shape == bench_interp.SHAPE and not offset,
                            mode=mode, offset=offset)
                  for derivative in (False, True) for mode in ("bicubic", "bilinear")
                  for shape, offset in ((bench_interp.SHAPE, 0), ((1, 9, 15, 77), 0),
                                        (bench_interp.SHAPE, 1), ((1, 9, 15, 77), 1))]
    for c in gen_checks:
        log("[kernel-gen] " + json.dumps(c))
    bad = [c for c in gen_checks if not c["ok"]]
    if bad:
        raise SystemExit(f"weight-generation kernel disagrees with its plain version: {bad}")
    phase_done("[kernel-gen]")

    # the contraction kernels at the microbenchmark's shapes and a tail shape
    # (V no multiple of a channel block, P none of a position tile)
    B_, H_, W_, V_ = bench_interp.SHAPE
    bench_mm = (B_, V_, H_ * W_, H_ + 2 * bench_interp.PAD, W_ + 2 * bench_interp.PAD)
    mm_tail = (1, 77, 1000, 13, 22)
    # the variants, and mmT on float32 operands (no variant of the bench)
    mm_variants = dict(bench_interp.MM_VARIANTS, mmT_f32_vb8=(torch.float32, 8, 1024))
    mm_checks = [check_mm(variant, spec, shape, timed=shape == bench_mm)
                 for variant, spec in mm_variants.items() for shape in (bench_mm, mm_tail)]
    mm_checks += [check_mm_blocks(kernel, cdt_name, shape, {
        c["variant"]: c["out_sha256"] for c in mm_checks
        if c["kernel"] == kernel and c["cdt"] == cdt_name and c["shape"] == list(shape)})
        for kernel in ("interp_mm", "interp_mmT") for cdt_name in ("float32", "bfloat16")
        for shape in (bench_mm, mm_tail)]
    mm_checks += [check_bwd_mm("bfloat16", "bfloat16", bench_mm, timed=True),
                  check_bwd_mm("float32", "bfloat16", bench_mm, timed=True),
                  check_bwd_mm("bfloat16", "bfloat16", mm_tail, timed=False),
                  check_bwd_mm("float32", "float32", mm_tail, timed=False),
                  check_bwd_mm("bfloat16", "float32", mm_tail, timed=False)]
    for c in mm_checks:
        log("[kernel-mm] " + json.dumps(c))
    bad = [c for c in mm_checks if not c["ok"]]
    if bad:
        raise SystemExit(f"contraction kernel disagrees with its plain version, or mm's "
                         f"or mmT's output with its own at another blocking: {bad}")
    phase_done("[kernel-mm]")

    runs, hr_runs, first_step = {}, {}, {}
    for grid, overrides, store in (((NLAT, NLON), (), runs), (HR, HR_OVERRIDES, hr_runs)):
        for dtype_name in ("float32", "bfloat16"):
            capture = first_step.setdefault(dtype_name, []) if store is runs else None
            res = run_forecast(dtype_name, card, grid, overrides, capture=capture)
            log("[forecast] " + json.dumps(res))
            if not res["ok"]:
                raise SystemExit(f"forecast rollout failed its checks: {res}")
            store[dtype_name] = res
            log(f"[forecast] {grid[0]}x{grid[1]} {dtype_name}: "
                f"{res['forecast_steps_per_s']:.2f} steps/s ({STEPS}-step rollout, batch 1, "
                f"banded {res['banded']}) on {card}")

    # the unbanded forward kernel on the 5.625° rollouts' own first-step inputs
    rollout_checks = [check_rollout_kernel(dtype_name, first_step.pop(dtype_name))
                      for dtype_name in ("float32", "bfloat16")]
    for c in rollout_checks:
        log("[kernel-rollout] " + json.dumps(c))
    bad = [c for c in rollout_checks if not c["ok"] or c["launches"] != runs[c["dtype"]]["layers"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version or the row-chunked kernel on "
                         f"the rollout's inputs: {bad}")
    # tools/bench_forecast's rollouts: #1 (#5 at 1.40625°) 320 times a rollout
    bad = {f"{r['grid']} {r['dtype']}": r["bench_forecast"]["launches_per_call"]
           for store, kernel in ((runs, "interp_fwd"), (hr_runs, "interp_band_fwd"))
           for r in store.values()
           if r["bench_forecast"]["launches_per_call"] != {kernel: 8 * STEPS}}
    if bad:
        raise SystemExit(f"bench_forecast's rollouts launched other kernels than 320 times the "
                         f"forward: {bad}")
    phase_done("[forecast], [kernel-rollout]")
    torch.cuda.empty_cache()

    # the dense interpolation path: no interpolation kernel at all
    reset_counts()
    before = bench_interp.launch_counts()
    dense = run_forecast("float32", card, (NLAT, NLON), ["compute.advection_impl=xla"])
    dense["all_kernel_launches"] = {k: n - before[k] for k, n in
                                    bench_interp.launch_counts().items()}
    log("[forecast-dense] " + json.dumps(dense))
    if not (dense["ok"] and dense["impl"] == "xla"
            and not any(dense["all_kernel_launches"].values())):
        raise SystemExit(f"dense forecast rollout failed its checks: {dense}")
    phase_done("[forecast-dense]")
    log(f"[forecast-dense] {NLAT}x{NLON} float32: {dense['forecast_steps_per_s']:.2f} steps/s "
        f"({STEPS}-step rollout, batch 1), device "
        f"{dense['profile']['device_ms_per_step']} ms/step, peak {dense['peak_mem_gb']:.2f} GB "
        f"on {card}")

    # the compute.advection_impl values of the JAX package on one forecast step
    impls = check_advection_impls(card)
    log("[advection-impl] " + json.dumps(impls))
    if not impls["ok"]:
        raise SystemExit(f"a compute.advection_impl value failed its checks: {impls}")
    phase_done("[advection-impl]")

    trains, hr_trains, first_bwd = {}, {}, {}
    for grid, overrides, steps, tol, store in (
            ((NLAT, NLON), TRAIN_OVERRIDES, TRAIN_STEPS, GRAD_TOL, trains),
            (HR, HR_TRAIN_OVERRIDES, HR_TRAIN_STEPS, HR_GRAD_TOL, hr_trains)):
        for dtype_name in ("bfloat16", "float32"):
            capture = first_bwd.setdefault(dtype_name, []) if store is trains else None
            res = run_train(dtype_name, card, grid, overrides, steps, tol, capture=capture)
            log("[train] " + json.dumps(res))
            if not res["ok"]:
                raise SystemExit(f"train steps failed their checks: {res}")
            store[dtype_name] = res
            log(f"[train] {grid[0]}x{grid[1]} {dtype_name}: {res['train_steps_per_s']:.2f} "
                f"train steps/s = samples/s (batch 1, S = {res['S']}, {res['optimizer']}, "
                f"banded {res['banded']}, checkpointing {res['gradient_checkpointing']}) "
                f"on {card}")

    # tools/bench_highres's steps: #5 16 times a step (8, and 8 in the
    # backward's replay) and #6 8 times
    bad = {k: r["bench_highres"]["launches_per_call"] for k, r in hr_trains.items()
           if r["bench_highres"]["launches_per_call"] != {"interp_band_fwd": 16,
                                                          "interp_band_bwd": 8}}
    if bad:
        raise SystemExit(f"bench_highres's steps launched other than #5 16 and #6 8 times a "
                         f"step: {bad}")

    phase_done("[train]")

    # [export]'s 5.625° inputs and cli.export, in a process of its own while
    # the device-bound 1.40625° phases run (prepare_export)
    import tempfile

    fio_dir = tempfile.TemporaryDirectory(prefix="paradis-fio-")
    # kept to [multi-gpu], which trains on [data]'s 5.625° store
    data_tmp = tempfile.TemporaryDirectory(prefix="paradis-data-")
    prep_log = open(Path(fio_dir.name) / "export_prep.log", "w")
    prep = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--worker",
                             "export", fio_dir.name, data_tmp.name], stdout=prep_log,
                            stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent,
                            start_new_session=True)
    # it and its cli.export end with this script, whatever its end
    atexit.register(lambda: prep.poll() is None and os.killpg(prep.pid, 9))

    # the 1.40625° bf16 train step under the policies that keep the
    # interpolation's output (and its positions) through the replay, beside
    # none's run above
    remat_trains = {"none": hr_trains["bfloat16"]}
    for policy in ("advect", "advect_pos"):
        overrides = HR_TRAIN_OVERRIDES + [f"compute.remat_policy={policy}"]
        res = run_train("bfloat16", card, HR, overrides, HR_TRAIN_STEPS, HR_GRAD_TOL)
        log("[train-remat] " + json.dumps(res))
        if not res["ok"] or res["remat_policy"] != policy:
            raise SystemExit(f"train steps under remat_policy {policy} failed their checks: {res}")
        remat_trains[policy] = res
    log("[train-remat] " + json.dumps({
        policy: {"device_ms_per_step": r["profile"]["device_ms_per_step"],
                 "busy_share": r["profile"]["busy_share"],
                 "device_launches_per_step": r["profile"].get("device_launches_per_step"),
                 "interp_launches_per_step": r["launches_per_step"][0],
                 "train_steps_per_s": r["train_steps_per_s"], "peak_mem_gb": r["peak_mem_gb"]}
        for policy, r in remat_trains.items()}))

    phase_done("[train-remat]")

    # the 1.40625° bf16 train step with the AMSE spectral loss, beside the
    # reversed Huber run above
    amse = run_train("bfloat16", card, HR, AMSE_OVERRIDES, HR_TRAIN_STEPS, HR_GRAD_TOL)
    log("[train-amse] " + json.dumps(amse))
    if not amse["ok"] or amse["loss"] != "amse":
        raise SystemExit(f"train steps with the AMSE loss failed their checks: {amse}")
    log("[train-amse] " + json.dumps({
        r["loss"]: {"train_steps_per_s": r["train_steps_per_s"],
                    "device_ms_per_step": r["profile"]["device_ms_per_step"],
                    "busy_share": r["profile"]["busy_share"],
                    "device_launches_per_step": r["profile"].get("device_launches_per_step"),
                    "peak_mem_gb": r["peak_mem_gb"], "losses": r["losses"]}
        for r in (hr_trains["bfloat16"], amse)}))

    phase_done("[train-amse]")

    # the spherical harmonic transform against a float64 analysis, and timed
    sht_check = check_sht(card)
    log("[sht] " + json.dumps(sht_check))
    if not sht_check["ok"]:
        raise SystemExit(f"the SHT disagrees with its float64 analysis: {sht_check}")
    log(f"[sht] {SHT_SHAPE}: analysis {sht_check['analysis_ms']:.4f} ms (Legendre bound "
        f"{sht_check['legendre_bound_ms']:.4f} ms), AMSE forward + backward "
        f"{sht_check['amse_fwd_bwd_ms']:.4f} ms, max rel err "
        f"{sht_check['max_rel_err_vs_float64']:.3g} on {card}")

    phase_done("[sht]")

    # save, restore and resume at 1.40625°, and a weights-only transfer to 5.625°
    ckpt = run_checkpoint(card)
    log("[checkpoint] " + json.dumps(ckpt))
    if not ckpt["ok"]:
        raise SystemExit(f"checkpoint save, restore, resume or transfer failed: {ckpt}")
    log(f"[checkpoint] {ckpt['checkpoint_bytes']} bytes, save {ckpt['save_s']:.2f} s, restore "
        f"{ckpt['restore_s']:.2f} s; resumed within {ckpt['resumed_loss_err']:.3g} (loss) and "
        f"{ckpt['resumed_param_err']:.3g} (parameters) of the uninterrupted run, whose "
        f"repeat spread {ckpt['loss_spread']:.3g} / {ckpt['param_spread']:.3g} on {card}")

    phase_done("[checkpoint]")

    # the data pipeline, then the host loop and the training CLI fed by it

    data_t0 = time.perf_counter()
    data_dir = data_tmp.name
    data = run_data(card, Path(data_dir), prep)
    data["seconds"] = time.perf_counter() - data_t0
    log("[data] " + json.dumps(data))
    if not data["ok"]:
        raise SystemExit(f"the data pipeline failed its checks: {data}")
    log(f"[data] native library built in {data['native_build_s']:.1f} s; "
        + "; ".join(f"{g}: raw store {st['build_s']:.1f} s / {st['raw_bytes']} B, "
                    f"preprocess {st['preprocess_s']:.1f} s / {st['store_bytes']} B"
                    for g, st in data["stores"].items())
        + f"; a 1.40625° sample ({data['sample_bytes']} B) in "
        f"{data['assemble_ms_median']:.1f} ms; a batch to the card pinned "
        f"{data['h2d_pinned_ms']:.2f} ms (copy alone {data['h2d_pinned_copy_only_ms']:.2f}), "
        f"pageable {data['h2d_pageable_ms']:.2f} ms; {data['seconds']:.1f} s on {card}")
    loop_t0 = time.perf_counter()
    loop_res = run_train_loop(card, Path(data_dir), data["stores"],
                              {"hr": hr_trains["bfloat16"]["train_steps_per_s"],
                               "lr": trains["bfloat16"]["train_steps_per_s"]})
    loop_res["seconds"] = time.perf_counter() - loop_t0
    log("[train-loop] " + json.dumps(loop_res))
    if not loop_res["ok"]:
        raise SystemExit(f"the host training loop failed its checks: {loop_res}")
    for key in ("hr", "lr"):
        r = loop_res[key]
        log(f"[train-loop] {r['grid'][0]}x{r['grid'][1]} bfloat16: "
            f"{r['loop_samples_per_s']:.3f} samples/s through the loop against "
            f"{r['device_resident_samples_per_s']:.3f} device-resident on {card}")
    turns = loop_res["lr"]["turns"]
    log(f"[train-loop] {NLAT}x{NLON} bfloat16 step in turns: "
        + ", ".join(f"{m} {r:.3f}" for m, r in turns["samples_per_s"].items())
        + " samples/s; by round against cached, quartiles: loader "
        + " / ".join(f"{q:.3f}" for q in turns["loader_over_cached_quartiles"])
        + ", native library on 1 thread "
        + " / ".join(f"{q:.3f}" for q in turns["capped_over_cached_quartiles"])
        + f" ({turns['native_threads']} threads otherwise) on {card}")
    log(f"[train-loop] 1.40625° busy share {loop_res['hr']['busy_share']:.3f}, syncs a step "
        f"inside the step {loop_res['hr']['syncs_inside_step']} (sync_every 1), "
        f"{loop_res['hr']['sync4']['syncs_inside_step']} (sync_every 4); "
        f"{loop_res['seconds']:.1f} s")
    torch.cuda.empty_cache()

    phase_done("[data], [train-loop]")

    # tools of scripts/ that run briefly here: the live loop's host phases
    # at full width, and the two convergence A/Bs on their toy model
    live = run_profile_live(card, data["stores"][f"{NLAT}x{NLON}"]["path"])
    log("[profile-live] " + json.dumps(live))
    if not live["ok"]:
        raise SystemExit(f"profile_live failed its checks: {live}")
    log(f"[profile-live] {NLAT}x{NLON} bfloat16: {live['samples_per_sec']:.3f} samples/s, "
        f"{live['wall_ms_per_step']:.1f} ms a step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in live["main_loop_ms_per_step"].items())
        + f" ms; assemble {live['overlapped_threads_ms']['assemble_per_sample']:.1f} ms a "
        f"sample on {card}")
    phase_done("[profile-live]")
    for tool in ("ns", "lq"):
        conv = run_convergence(card, tool)
        log(f"[{tool}-convergence] " + json.dumps(conv))
        if not conv["ok"]:
            raise SystemExit(f"{tool}_convergence failed its checks: {conv}")
        phase_done(f"[{tool}-convergence]")
    torch.cuda.empty_cache()

    # forecast I/O: the forecast CLI writes a WB2 store from the card, scored
    fio_t0 = time.perf_counter()
    # kept to [export], which exports the 5.625° checkpoint on the 5.625° store
    fio = run_forecast_io(card, Path(fio_dir.name), prep)
    fio["seconds"] = time.perf_counter() - fio_t0
    log("[forecast-io] " + json.dumps(fio))
    if not fio["ok"]:
        raise SystemExit(f"the forecast CLI, its store or its scores failed their checks: {fio}")
    for key in (f"{NLAT}x{NLON}", f"{HR[0]}x{HR[1]}"):
        r = fio[key]
        st = r["stats"]
        log(f"[forecast-io] {key} float32 through cli.forecast: "
            f"{r['forecast_steps_per_s_cli']:.3f} steps/s ({r['samples']} init(s) x {STEPS} "
            f"steps, batch 1) against {r['forecast_steps_per_s_device']:.3f} device-only; "
            f"rollout {st['rollout_s']:.2f} s, device-to-host copy {st['copy_s']:.3f} s "
            f"({st['copy_bytes']} B), writes {st['write_s']:.2f} s ({r['write_bytes']} B "
            f"on disk), evaluate {r['evaluate']['raw']['seconds']:.2f} s (raw) / "
            f"{r['evaluate']['preprocessed']['seconds']:.2f} s (preprocessed); store "
            f"build {r['build_s']:.1f} s, preprocess {r['preprocess_s']:.1f} s on {card}")
    torch.cuda.empty_cache()

    phase_done("[forecast-io]")

    # the serving export: torch.export programs loaded back, on the kernels
    export = run_export(card, Path(fio_dir.name), prep)
    prep_log.close()
    log("[export] " + json.dumps(export))
    if not export["ok"]:
        raise SystemExit(f"the serving artifact failed its checks: {export}")
    for key, r in export.items():
        if key in ("ok", "export_wait_s"):
            continue
        log(f"[export] {key} float32: export {r['export_seconds']} s"
            + (f" (cli.export {r['cli_export_s']:.1f} s)" if "cli_export_s" in r else "")
            + f", load "
            f"{r['load_seconds']:.1f} s, bytes {r['file_bytes']}; steps/s {r['steps_per_s']} "
            f"({STEPS} steps, batch 1); gaps {r['max_abs_gap']} of max |out| "
            f"{r['max_abs_out']:.4g}; torch {r['torch_version']} on {card}")
    torch.cuda.empty_cache()

    phase_done("[export]")

    # the model-level benchmark, both impls in turns
    bench_mod = run_bench_model(card)
    report_bench_model(bench_mod, card)
    torch.cuda.empty_cache()

    phase_done("[bench-model]")

    # the multi-rank paths, each in its own processes; the spatial runs beside
    mg_dir = tempfile.TemporaryDirectory(prefix="paradis-mg-")
    lr_store = Path(data["stores"][f"{NLAT}x{NLON}"]["path"])
    sp_root = Path(mg_dir.name) / "spatial"
    sp_wait = start_spatial(lr_store, Path(fio_dir.name), sp_root)
    mg = run_multi_gpu(card, lr_store, Path(fio_dir.name), Path(mg_dir.name))
    report_multi_gpu(mg, card)
    torch.cuda.empty_cache()

    phase_done("[multi-gpu]")

    sp = finish_spatial(sp_wait, sp_root, mg["nccl"], Path(fio_dir.name),
                        fio[f"{HR[0]}x{HR[1]}"])
    report_spatial(sp, card)

    phase_done("[spatial]")

    # FSDP over a data x lat grid, alone: the two launches before hold the host's cores
    report_spatial_fsdp(run_spatial_fsdp(lr_store, sp_root, mg["nccl"], sp["lat2"]), card)

    phase_done("[spatial-fsdp]")

    # bench_pipeline and roofline --cost, run by the preparing process
    report_host_tools(wait_ready(Path(fio_dir.name) / TOOLS_READY, prep, "its host tools"),
                      card)
    mg_dir.cleanup()
    fio_dir.cleanup()
    data_tmp.cleanup()

    phase_done("[bench-pipeline], [roofline]")

    # the unbanded backward kernel on the 5.625° train steps' own first-step inputs
    train_bwd_checks = [check_train_bwd_kernel(dtype_name, first_bwd.pop(dtype_name))
                        for dtype_name in ("bfloat16", "float32")]
    for c in train_bwd_checks:
        log("[kernel-bwd-train] " + json.dumps(c))
    bad = [c for c in train_bwd_checks
           if not c["ok"] or c["launches"] != trains[c["dtype"]]["layers"]]
    if bad:
        raise SystemExit(f"backward kernel disagrees with its plain version or the row-chunked "
                         f"kernel on the train step's inputs: {bad}")
    torch.cuda.empty_cache()

    phase_done("[kernel-bwd-train]")

    # the serving and training paths through the row-chunked kernels
    chunk_runs, chunk_trains = {}, {}
    for grid, overrides, rw, ab_pairs in (((NLAT, NLON), (), CHUNK_RW, 1),
                                          (HR, HR_CHUNK_OVERRIDES, HR_CHUNK_RW, 0)):
        res = run_forecast("float32", card, grid, overrides, chunk_rw=rw, ab_pairs=ab_pairs)
        log("[forecast-chunk] " + json.dumps(res))
        if not res["ok"]:
            raise SystemExit(f"chunked forecast rollout failed its checks: {res}")
        chunk_runs[grid] = res
        log(f"[forecast-chunk] {grid[0]}x{grid[1]} float32 rw {rw}: "
            f"{res['forecast_steps_per_s']:.2f} steps/s ({STEPS}-step rollout, batch 1; in "
            f"turns {res.get('ab_forecast_steps_per_s')}) on {card}")
    for grid, overrides, steps, tol, rw in (
            ((NLAT, NLON), TRAIN_OVERRIDES, TRAIN_STEPS, GRAD_TOL, CHUNK_RW),
            (HR, HR_CHUNK_TRAIN_OVERRIDES, HR_TRAIN_STEPS, HR_GRAD_TOL, HR_CHUNK_RW)):
        res = run_train("bfloat16", card, grid, overrides, steps, tol, chunk_rw=rw)
        log("[train-chunk] " + json.dumps(res))
        if not res["ok"]:
            raise SystemExit(f"chunked train steps failed their checks: {res}")
        chunk_trains[grid] = res
        log(f"[train-chunk] {grid[0]}x{grid[1]} bfloat16 rw {rw}: "
            f"{res['train_steps_per_s']:.2f} train steps/s (batch 1, checkpointing "
            f"{res['gradient_checkpointing']}) on {card}")

    # the bilinear route on the model's paths: the launches of the kernels
    # line's bilinear records
    reset_counts()
    bilinear_paths = run_bilinear_paths()
    log("[bilinear-paths] " + json.dumps(bilinear_paths))
    bad = {k: r for k, r in bilinear_paths.items() if not r["ok"]}
    if bad:
        raise SystemExit(f"a bilinear path launched other kernels, or other counts, than it "
                         f"takes, or gave non-finite values: {bad}")

    phase_done("[forecast-chunk], [train-chunk], [bilinear-paths]")

    # the device time a step of the forecasts and train steps, beside this
    # script's earlier figures (EARLIER_DEVICE_MS)
    device_ms = {f"forecast {k}": runs[k]["profile"]["device_ms_per_step"] for k in runs}
    device_ms.update({f"forecast {k} {HR[0]}x{HR[1]}": hr_runs[k]["profile"]["device_ms_per_step"]
                      for k in hr_runs})
    device_ms.update({f"train {k}": trains[k]["profile"]["device_ms_per_step"] for k in trains})
    device_ms.update({f"train {k} {HR[0]}x{HR[1]}": hr_trains[k]["profile"]["device_ms_per_step"]
                      for k in hr_trains})
    device_ms.update({f"train-chunk bfloat16 {g[0]}x{g[1]}": r["profile"]["device_ms_per_step"]
                      for g, r in chunk_trains.items()})
    device_ms.update({f"train bfloat16 {HR[0]}x{HR[1]} remat {p}":
                      r["profile"]["device_ms_per_step"]
                      for p, r in remat_trains.items() if p != "none"})
    device_ms[f"train bfloat16 {HR[0]}x{HR[1]} amse"] = amse["profile"]["device_ms_per_step"]
    log("[device-ms] " + json.dumps({"device_ms_per_step": device_ms,
                                     "earlier_device_ms_per_step": EARLIER_DEVICE_MS}))

    # the microbenchmark, the main path of the weight-generation and the
    # contraction kernels
    from paradis_torch.ops import interp_gen, interp_mm

    interp_gen.gen_launches = interp_gen.bwd_gen_launches = 0
    interp_mm.mm_launches = interp_mm.mmT_launches = interp_mm.bwd_mm_launches = 0
    bench = bench_interp.main(["--repeats", str(BENCH_INTERP_REPEATS)])
    bench_launches = {k: n for k, n in bench_interp.launch_counts().items()
                      if k in ("interp_gen", "interp_bwd_gen", "interp_mm", "interp_mmT",
                               "interp_bwd_mm")}
    log("[bench-interp] " + json.dumps(dict(bench, bench_launches=bench_launches)))
    per_op = bench["launches_per_op"]
    bench_ok = (list(bench["ms_per_op"]) == list(bench_interp.VARIANTS)
                and all(ms > 0 for ms in bench["ms_per_op"].values())
                and per_op["xla_fwd"] == {} and per_op["xla_fwdbwd"] == {}
                and per_op["cuda_fwd"] == {"interp_fwd": 1}
                and per_op["cuda_fwdbwd"] == {"interp_fwd": 1, "interp_bwd": 1}
                and per_op["chunked_fwd"] == {"interp_chunk_fwd": 1}
                and per_op["chunked_fwdbwd"] == {"interp_chunk_fwd": 1, "interp_chunk_bwd": 1}
                and per_op["genonly"] == {"interp_gen": 1}
                and all(per_op[name] == {"interp_mmT" if name.startswith("mmT") else "interp_mm": 1}
                        for name in bench_interp.MM_VARIANTS)
                and per_op["bwd_genonly"] == {"interp_bwd_gen": 1}
                and per_op["bwd_mmonly"] == {"interp_bwd_mm": 1}
                and per_op["ns_update"] == {} and all(bench_launches.values()))
    if not bench_ok:
        raise SystemExit(f"the interpolation microbenchmark failed its checks: {bench}")

    phase_done("[bench-interp]")

    # one record per kernel variant on the main paths (bicubic), its launches
    # counted in the run of the path that takes it: the forward kernels in
    # the first rollout (or, for a chunked bf16 record, the first chunked
    # train step), the backward kernels in the first train step, the
    # weight-generation and contraction kernels in the microbenchmark (the
    # run of their variant)
    hr_chunk = HR[0] + 4
    kernels = []

    def chunk_grid(c):
        return HR if c["shape"][1] == hr_chunk else (NLAT, NLON)

    for name, source, replaces, found, launches in (
            ("interp_fwd", KERNEL_SOURCE, REPLACES, checks,
             lambda c: runs[c["dtype"]]["launches_per_rollout"][0][0]),
            ("interp_bwd", BWD_SOURCE, BWD_REPLACES, bwd_checks,
             lambda c: trains[c["dtype"]]["launches_per_step"][0][1]),
            ("interp_band_fwd", BAND_SOURCE, BAND_REPLACES, band_checks,
             lambda c: hr_runs[c["dtype"]]["launches_per_rollout"][0][2]),
            ("interp_band_bwd", BAND_BWD_SOURCE, BAND_BWD_REPLACES, band_bwd_checks,
             lambda c: hr_trains[c["dtype"]]["launches_per_step"][0][3]),
            ("interp_chunk_fwd", CHUNK_SOURCE, CHUNK_REPLACES, chunk_checks,
             lambda c: (chunk_runs[chunk_grid(c)]["launches_per_rollout"][0][4]
                        if c["dtype"] == "float32"
                        else chunk_trains[chunk_grid(c)]["launches_per_step"][0][4])),
            ("interp_chunk_bwd", CHUNK_BWD_SOURCE, CHUNK_BWD_REPLACES,
             [c for c in chunk_bwd_checks if c["dtype"] == "bfloat16"],
             lambda c: chunk_trains[chunk_grid(c)]["launches_per_step"][0][5])):
        for c in found:
            if c["mode"] == "bicubic" and "ms" in c:
                tag = f",rw{c['chunk_rw']},{c['shape'][4]}x{c['shape'][5]}" if "chunk_rw" in c else ""
                rec = {"name": f"{name}[bicubic,{c['dtype']}{tag}]", "route": "cuda",
                       "source": source, "replaces": replaces, "launches": launches(c),
                       "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                       "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                       "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
                for extra in ("unbanded_ms", "banded_ms", "chunk_ms"):
                    if extra in c:
                        rec[extra] = c[extra]
                kernels.append(rec)
    kernels += bilinear_records(checks, bwd_checks, band_checks, band_bwd_checks,
                                chunk_checks, chunk_bwd_checks, bilinear_paths)
    # the forecast CLI's launches beside the fp32 records of its kernels
    for k in kernels:
        if k["name"] == "interp_fwd[bicubic,float32]":
            k["cli_forecast_launches"] = fio[f"{NLAT}x{NLON}"]["launches"][0]
        if k["name"] == "interp_band_fwd[bicubic,float32]":
            k["cli_forecast_launches"] = fio[f"{HR[0]}x{HR[1]}"]["launches"][2]
    # and the serving artifact's: one rollout.pt2 call, one forward.pt2 call
    ex_lr, ex_hr = export[f"{NLAT}x{NLON}"], export[f"{HR[0]}x{HR[1]}"]
    for k in kernels:
        if k["name"] == "interp_fwd[bicubic,float32]":
            k["artifact_rollout_launches"] = ex_lr["launches_per_call"]["rollout"]["interp_fwd"]
            k["artifact_forward_launches_per_call"] = (
                ex_lr["launches_per_call"]["steploop"]["interp_fwd"] // STEPS)
        if k["name"] == "interp_band_fwd[bicubic,float32]":
            k["artifact_forward_launches_per_call"] = (
                ex_hr["launches_per_call"]["steploop"]["interp_band_fwd"] // STEPS)
    # and the multi-rank runs' on each rank ([multi-gpu]), and bench_model's a call
    for k in kernels:
        if k["name"] == "interp_fwd[bicubic,bfloat16]":
            k["data_parallel_launches_per_rank"] = [r["launches"][0] for r in mg["dp"]["ranks"]]
            k["bench_model_launches_per_call"] = (
                bench_mod["rows"]["pallas_fwd"]["launches_per_call"]["interp_fwd"])
        if k["name"] == "interp_bwd[bicubic,bfloat16]":
            k["data_parallel_launches_per_rank"] = [r["launches"][1] for r in mg["dp"]["ranks"]]
            k["bench_model_launches_per_call"] = (
                bench_mod["rows"]["pallas_bwd"]["launches_per_call"]["interp_bwd"])
        if k["name"] == "interp_fwd[bicubic,float32]":
            k["forecast_launches_per_rank"] = mg["forecast"]["launches"]
    # and a call of the tools: a bench_forecast rollout, a bench_highres step,
    # the profile_live run (PROFILE_LIVE_ARGS)
    tool_launches = {
        "interp_fwd[bicubic,float32]": ("bench_forecast_launches_per_rollout",
                                        runs["float32"]["bench_forecast"], "interp_fwd"),
        "interp_band_fwd[bicubic,float32]": ("bench_forecast_launches_per_rollout",
                                             hr_runs["float32"]["bench_forecast"],
                                             "interp_band_fwd"),
        "interp_band_fwd[bicubic,bfloat16]": ("bench_highres_launches_per_step",
                                              hr_trains["bfloat16"]["bench_highres"],
                                              "interp_band_fwd"),
        "interp_band_bwd[bicubic,bfloat16]": ("bench_highres_launches_per_step",
                                              hr_trains["bfloat16"]["bench_highres"],
                                              "interp_band_bwd")}
    for k in kernels:
        if k["name"] in tool_launches:
            key, timed, kernel = tool_launches[k["name"]]
            k[key] = timed["launches_per_call"][kernel]
        if k["name"] == "interp_fwd[bicubic,bfloat16]":
            k["profile_live_launches"] = live["launches"][0]
        if k["name"] == "interp_bwd[bicubic,bfloat16]":
            k["profile_live_launches"] = live["launches"][1]
    for c in rollout_checks:
        kernels.append({"name": f"interp_fwd[{c['mode']},{c['dtype']},rollout]", "route": "cuda",
                        "source": KERNEL_SOURCE, "replaces": REPLACES,
                        "launches": runs[c["dtype"]]["launches_per_rollout"][0][0],
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                        "chunk_ms": c["chunk_ms"]})
    for c in train_bwd_checks:
        kernels.append({"name": f"interp_bwd[{c['mode']},{c['dtype']},train]", "route": "cuda",
                        "source": BWD_SOURCE, "replaces": BWD_REPLACES,
                        "launches": trains[c["dtype"]]["launches_per_step"][0][1],
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                        "chunk_ms": c["chunk_ms"]})
    for c in gen_checks:
        if "ms" in c and c["mode"] == "bicubic":
            name = "interp_bwd_gen" if c["derivative"] else "interp_gen"
            kernels.append({"name": f"{name}[bicubic,float32]", "route": "cuda",
                            "source": GEN_SOURCE,
                            "replaces": BWD_GEN_REPLACES if c["derivative"] else GEN_REPLACES,
                            "launches": bench_launches[name], "max_abs_err": c["max_abs_err"],
                            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    in_run = bench["launches_per_run"]
    for c in mm_checks:
        if "ms" not in c:
            continue
        # the cases the microbenchmark runs: its variants, and bwd_mm on a bf16 field
        if not (c["variant"] in in_run if "variant" in c else c["field_dtype"] == "bfloat16"):
            continue
        if "variant" in c:
            name, replaces = c["kernel"], MMT_REPLACES if c["kernel"] == "interp_mmT" else MM_REPLACES
            rec = {"name": f"{name}[{c['cdt']},vb{c['vb']},pb{c['pb']}]",
                   "launches": in_run[c["variant"]].get(name, 0), "einsum_ms": c["einsum_ms"]}
        else:
            rec = {"name": f"interp_bwd_mm[{c['cdt']}]",
                   "launches": in_run["bwd_mmonly"].get("interp_bwd_mm", 0)}
            replaces = BWD_MM_REPLACES
        rec.update({"route": "cuda", "source": MM_SOURCE, "replaces": replaces,
                    "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                    "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                    "library_ms": c["library_ms"]})
        kernels.append(rec)
    missing = {"interp_fwd", "interp_bwd", "interp_band_fwd", "interp_band_bwd",
               "interp_chunk_fwd", "interp_chunk_bwd", "interp_gen", "interp_bwd_gen",
               "interp_mm", "interp_mmT", "interp_bwd_mm"} - {
                   k["name"].split("[")[0] for k in kernels if k["launches"] > 0}
    if missing:
        raise SystemExit(f"kernels not launched on their main path: {sorted(missing)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:3] == ["--worker", "export"]:
        sys.exit(prepare_export(Path(sys.argv[3]), Path(sys.argv[4])))
    sys.exit(rank_worker(sys.argv[2:]) if sys.argv[1:2] == ["--worker"] else main())
