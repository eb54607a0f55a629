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
   (``resident``: each channel group's whole field in shared memory, or
   ``window``: each tile's row window); time the kernel, the row-chunked
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
   ``configs/default.yaml`` with seeded random weights, runs a 40-step
   forecast rollout at batch 1 in float32 and in bfloat16 through
   ``make_forecast_rollout``.  Outputs must be finite, the kernel's launch
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
   ``compute.gradient_checkpointing=true`` for ``HR_TRAIN_STEPS`` steps: each
   step launches the banded forward 16 times (8, and 8 in the backward's
   replay), the banded backward 8 times and the unbanded kernels never.
   ``[train-remat]``: the same bf16 1.40625° steps under
   ``compute.remat_policy=advect`` and ``advect_pos`` (the replay keeps the
   interpolation's output, and its departure positions), each launching the
   banded forward only 8 times a step, with its device ms, busy share,
   launches and peak memory beside the ``none`` run's.
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
   (``EARLIER_DEVICE_MS``);
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
    interpolation kernel, its first step against the plain path;
12. the port's interpolation microbenchmark (``[bench-interp]``,
    ``python3 -m paradis_torch.tools.bench_interp``), all fifteen variants.

The last lines are the card line, one JSON object with a record per kernel,
and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository beside it, the script fails before printing any result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

STEPS = 40                 # the 10-day forecast protocol: 40 × 6 h
PROFILE_STEPS = 3          # rollout steps traced by torch.profiler
NLAT, NLON = 32, 64        # 5.625°
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bfloat16 on the tensor cores
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
GEN_SOURCE = "paradis_torch/csrc/interp_gen.cu"
GEN_REPLACES = "scripts/bench_interp.py:107"
BWD_GEN_REPLACES = "scripts/bench_interp.py:221"
MM_SOURCE = "paradis_torch/csrc/interp_mm.cu"
MM_REPLACES = "scripts/bench_interp.py:138"
MMT_REPLACES = "scripts/bench_interp.py:176"
BWD_MM_REPLACES = "scripts/bench_interp.py:248"
CHUNK_RW = 8               # PARADIS_INTERP_CHUNK of the 5.625° chunked runs
HR_CHUNK_RW = 32           # and of the 1.40625° ones
TRAIN_STEPS = 10           # train steps on one batch (the first is the warm-up)
TRAIN_PROFILE_STEPS = 2    # train steps traced by torch.profiler
# WSD with a short warmup, so the few steps run at the configured rate
TRAIN_OVERRIDES = ["training.scheduler.wsd.warmup=3"]
HR = (128, 256)            # 1.40625°
BAND_RAD = 0.3             # compute.interp_band_rad of the 1.40625° runs
HR_OVERRIDES = [f"compute.interp_band_rad={BAND_RAD}"]
# the 1.40625° train configuration: banded interpolation and full
# recomputation of each physics layer in the backward
HR_TRAIN_OVERRIDES = TRAIN_OVERRIDES + HR_OVERRIDES + ["compute.gradient_checkpointing=true"]
HR_TRAIN_STEPS = 6         # train steps at 1.40625° (the first is the warm-up)
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


def bound(field, py, mode: str):
    """(bound_ms, bound_by): each input read once and the output written once
    over the memory rate, against the flops the taps need over the fp32 rate."""
    n_out = py.numel()
    nbytes = field.numel() * field.element_size() + 2 * n_out * 4 + n_out * field.element_size()
    # per output: weights (4 cubic polynomials per axis, ~6 flops each, or 2
    # linear), one FMA per tap, one FMA per tap row
    flops = n_out * ((2 * 4 * 6 + 16 * 2 + 4 * 2) if mode == "bicubic" else (2 * 2 + 4 * 2 + 2 * 2))
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


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
        res["bitwise_equal_unbanded"] = bool(torch.equal(out, refs["unbanded"]))
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


def bound_bwd(field, py, g, mode: str):
    """(bound_ms, bound_by) of the backward: field, both positions and g read
    once; d_field (field's dtype), d_py and d_px (fp32) written once; against
    the flops it needs over the fp32 rate."""
    n_out = py.numel()
    f_bytes = field.numel() * field.element_size()
    nbytes = 2 * f_bytes + 2 * n_out * 4 + n_out * g.element_size() + 2 * n_out * 4
    # per output: weights and derivatives (4 cubic polynomials each, ~6-8
    # flops, per axis; or 2 linear); per tap two FMAs (f·K, f·K′), one product
    # g·K·K and its add into d_field; per tap row two FMAs and one product
    if mode == "bicubic":
        flops = n_out * (2 * 4 * (6 + 8) + 16 * 6 + 4 * 5 + 2)
    else:
        flops = n_out * (2 * 2 * (2 + 2) + 4 * 6 + 2 * 5 + 2)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


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
           "integer_positions": integer, "ok": out[0].dtype == dtype}
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


def flagship_dims(cfg) -> dict:
    f = cfg.features
    n_levels = len(f.pressure_levels)
    n_common = len(f.input.atmospheric) * n_levels + len(f.input.surface)
    n_out = len(f.output.atmospheric) * n_levels + len(f.output.surface)
    n_time = int(cfg.dataset.n_time_inputs)
    n_forcings, n_const = len(f.input.forcings), len(f.input.constants)
    return dict(n_common=n_common, n_out=n_out, n_time=n_time, n_forcings=n_forcings,
                n_const=n_const, input_dim=(n_common + n_forcings) * n_time + n_const)


def profile_steps(run, n_steps: int, wall_per_step_s: float) -> dict:
    """Device time per step, by kernel, from ``run()`` traced (it takes
    ``n_steps`` steps).

    The busy share divides it by the untraced wall time per step (the
    tracer slows the host, not the device's work).  Annotated ranges on the
    device timeline (the optimizers' ``record_function`` spans) are not
    kernels and are left out.  ``None`` where the profiler saw no device
    activity.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us <= 0:
        return {"device_ms_per_step": None, "busy_share": None}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    per_step_ms = dev_us / 1e3 / n_steps
    return {
        "device_ms_per_step": per_step_ms,
        "device_launches_per_step": sum(e.count for e in kernels) / n_steps,
        "busy_share": per_step_ms / (wall_per_step_s * 1e3),
        "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / 1e3 / n_steps
                                    for e in top},
    }


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
    from paradis_torch.model import Paradis
    from paradis_torch.sphere.geometry import equiangular_lat_lon

    dtype = getattr(torch, dtype_name)
    nlat, nlon = grid
    cfg = load_config(overrides=list(overrides))
    cfg.forecast.output_frequency = 1
    d = flagship_dims(cfg)
    lat, lon = equiangular_lat_lon(nlat, nlon, include_poles=False)
    torch.cuda.reset_peak_memory_stats()
    model = Paradis.from_config(cfg, input_dim=d["input_dim"], output_dim=d["n_out"],
                                lat_deg=lat, lon_deg=lon, dtype=dtype, device="cuda")
    n_layers = len(model.layers)
    n_params = sum(p.numel() for p in model.parameters())
    banded = band_on(model, nlat, nlon)
    impl = model.layers[0].advection.impl   # "xla": the dense path, no kernel
    rng = np.random.default_rng(0)
    batch = {
        "input": rng.normal(size=(1, nlat, nlon, d["n_common"] * d["n_time"])),
        "forcings": rng.normal(size=(1, STEPS, nlat, nlon, d["n_forcings"] * d["n_time"])),
        "constants": rng.normal(size=(1, nlat, nlon, d["n_const"])),
    }
    batch = {k: torch.tensor(v, dtype=torch.float32, device="cuda") for k, v in batch.items()}
    rollout = make_forecast_rollout(model, cfg)

    warm = dict(batch, forcings=batch["forcings"][:, :2])
    with (recording_fwd(capture, n_layers) if capture is not None
          else contextlib.nullcontext()):
        rollout(warm, d["n_common"])
    torch.cuda.synchronize()

    times, counts, out = [], [], None
    for _ in range(3):
        reset_counts()
        t0 = time.perf_counter()
        out = rollout(batch, d["n_common"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(launch_counts())
    # the path's forward kernel once per layer and step
    expected = expected_launches(n_layers * STEPS if impl == "auto" else 0, 0, banded, chunk_rw)
    median = sorted(times)[1]
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
    short = dict(batch, forcings=batch["forcings"][:, :PROFILE_STEPS])
    profile = profile_steps(lambda: rollout(short, d["n_common"]), PROFILE_STEPS,
                            median / STEPS)

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
    res = {
        "dtype": dtype_name, "card": card, "grid": [nlat, nlon], "overrides": list(overrides),
        "impl": impl, "band_px": model.band_max_dy_pix, "banded": banded, "chunk_rw": chunk_rw,
        "params": n_params, "layers": n_layers,
        "out_shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
        "out_std": float(out.std()), "launches_per_rollout": counts,
        "expected_launches": expected, "rollout_s": times,
        "forecast_steps_per_s": STEPS / median,
        "first_step_max_abs_diff_vs_plain": step_err, "first_step_max_abs": step_scale,
        "first_step_limit": STEP_TOL[dtype_name] * max(step_scale, 1e-3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile,
    }
    if ab_pairs:
        res["ab_rollout_s"] = ab_times
        res["ab_forecast_steps_per_s"] = {k: STEPS / float(np.median(v))
                                          for k, v in ab_times.items()}
    res["ok"] = (res["finite"] and all(c == expected for c in counts) and ab_ok
                 and plain_launches == [0] * 6
                 and res["out_shape"] == [1, STEPS, nlat, nlon, d["n_out"]]
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
    from paradis_torch.model import Paradis
    from paradis_torch.sphere.geometry import equiangular_lat_lon
    from paradis_torch.train import (WeightedLoss, build_optimizer, build_schedule,
                                     create_train_state, make_train_step, set_learning_rate)

    nlat, nlon = grid
    overrides = list(overrides) + ([] if dtype_name == "bfloat16" else ["compute.use_amp=false"])
    cfg = load_config(overrides=overrides)
    d = flagship_dims(cfg)
    S = int(cfg.model.forecast_steps)
    lat, lon = equiangular_lat_lon(nlat, nlon, include_poles=False)
    torch.cuda.reset_peak_memory_stats()
    model = Paradis.from_config(cfg, input_dim=d["input_dim"], output_dim=d["n_out"],
                                lat_deg=lat, lon_deg=lon, device="cuda")
    n_layers = len(model.layers)
    banded = band_on(model, nlat, nlon)
    loss_fn = WeightedLoss.from_config(cfg, lat, dyn_output_features(cfg.features),
                                       device="cuda")
    optimizer = build_optimizer(cfg, model)
    lr_at, _ = build_schedule(cfg, int(cfg.training.max_steps))
    state = create_train_state(model, optimizer)
    train_step = make_train_step(model, loss_fn, cfg, optimizer)
    rng = np.random.default_rng(0)
    batch = {
        "input": rng.normal(size=(1, nlat, nlon, d["n_common"] * d["n_time"])),
        "target": rng.normal(size=(1, S, nlat, nlon, d["n_out"])),
        "forcings": rng.normal(size=(1, S, nlat, nlon, d["n_forcings"] * d["n_time"])),
        "constants": rng.normal(size=(1, nlat, nlon, d["n_const"])),
    }
    batch = {k: torch.tensor(v, dtype=torch.float32, device="cuda") for k, v in batch.items()}

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

    losses, gnorms, counts, times = [], [], [], []
    for i in range(steps):
        set_learning_rate(optimizer, lr_at(state.step))
        reset_counts()
        t0 = time.perf_counter()
        with (recording_bwd(capture, n_layers * S) if capture is not None and i == 0
              else contextlib.nullcontext()):
            metrics = train_step(state, batch, d["n_common"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(launch_counts())
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    median = float(np.median(times[1:]))

    def traced():
        for _ in range(TRAIN_PROFILE_STEPS):
            train_step(state, batch, d["n_common"])

    profile = profile_steps(traced, TRAIN_PROFILE_STEPS, median)
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
        "model_dtype": str(model.dtype),
        "optimizer": optimizer.name, "ns_dtype": str(optimizer.ns_dtype), "S": S,
        "layers": n_layers, "params": sum(p.numel() for p in model.parameters()),
        "losses": losses, "grad_norms": gnorms, "lrs": [lr_at(i) for i in range(steps)],
        "launches_per_step": counts, "expected_launches": expected, "step_s": times,
        "train_steps_per_s": 1.0 / median,
        "first_step_grad_launches": grad_launches,
        "first_step_grad_max_abs": grad_scale, "first_step_grad_rel_err_vs_plain": grad_err,
        "first_step_grad_limit": grad_tol[dtype_name],
        "optimizer_step_wall_ms": opt_s * 1e3, "optimizer_share_of_step_wall": opt_s / median,
        "optimizer_profile": opt_profile,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile,
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
    log(f"[forecast-dense] {NLAT}x{NLON} float32: {dense['forecast_steps_per_s']:.2f} steps/s "
        f"({STEPS}-step rollout, batch 1), device "
        f"{dense['profile']['device_ms_per_step']} ms/step, peak {dense['peak_mem_gb']:.2f} GB "
        f"on {card}")

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

    # the serving and training paths through the row-chunked kernels
    chunk_runs, chunk_trains = {}, {}
    for grid, overrides, rw, ab_pairs in (((NLAT, NLON), (), CHUNK_RW, 3),
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
    log("[device-ms] " + json.dumps({"device_ms_per_step": device_ms,
                                     "earlier_device_ms_per_step": EARLIER_DEVICE_MS}))

    # the microbenchmark, the main path of the weight-generation and the
    # contraction kernels
    from paradis_torch.ops import interp_gen, interp_mm

    interp_gen.gen_launches = interp_gen.bwd_gen_launches = 0
    interp_mm.mm_launches = interp_mm.mmT_launches = interp_mm.bwd_mm_launches = 0
    bench = bench_interp.main([])
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
    sys.exit(main())
