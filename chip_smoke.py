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
   bilinear, float32 and bfloat16, plus an odd P·V tail shape; time the
   kernel, the plain version and ``F.grid_sample`` (a yardstick the port
   never calls) with CUDA events, beside the kernel's memory/compute bound;
4. hold the interpolation backward kernel against its plain backward at the
   same shapes (the cotangent a seeded normal in the field's dtype), plus a
   bilinear case with every position on an integer (where K′ is zero at the
   kinks); time the kernel, the plain backward and the backward of
   ``F.grid_sample`` (``torch.autograd.grad``, a yardstick the port never
   calls), beside the backward's memory/compute bound;
5. the serving path: the full-width flagship ``Paradis`` (latent 1024, 768
   velocity vectors, 8 layers, bicubic, fast departure trig) built from
   ``configs/default.yaml`` with seeded random weights, runs a 40-step
   forecast rollout at batch 1 in float32 and in bfloat16 through
   ``make_forecast_rollout``.  Outputs must be finite, the kernel's launch
   count must rise by exactly 8 × 40 per rollout, and the first step must
   agree with the same model routed through the plain interpolation;
6. the training path: the same flagship in the configuration
   ``configs/default.yaml`` trains (bf16 compute with fp32 parameters,
   NorMuon with bf16 Newton–Schulz, weighted reversed Huber with latitude
   weights, 1 forecast step, batch 1; and the same in float32 with
   ``compute.use_amp=false``) takes ``TRAIN_STEPS`` steps through
   ``make_train_step`` on one seeded random batch, on the WSD schedule with a
   short warmup.  Losses and gradient norms must be finite, the last loss
   below the first, each step must launch the forward and the backward
   kernel exactly 8 × S times, and the first step's parameter gradients must
   agree with those through the plain interpolation.

The last lines are the card line, one JSON object with a record per kernel,
and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository beside it, the script fails before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

STEPS = 40                 # the 10-day forecast protocol: 40 × 6 h
PROFILE_STEPS = 3          # rollout steps traced by torch.profiler
NLAT, NLON = 32, 64        # 5.625°
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
KERNEL_SOURCE = "paradis_torch/csrc/interp_fwd.cu"
REPLACES = "paradis_tpu/ops/interp_pallas.py:172"
BWD_SOURCE = "paradis_torch/csrc/interp_bwd.cu"
BWD_REPLACES = "paradis_tpu/ops/interp_pallas.py:195"
TRAIN_STEPS = 10           # train steps on one batch (the first is the warm-up)
TRAIN_PROFILE_STEPS = 2    # train steps traced by torch.profiler
# WSD with a short warmup, so the few steps run at the configured rate
TRAIN_OVERRIDES = ["training.scheduler.wsd.warmup=3"]
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
# sums the contributions of the up to ~16 positions that tap it, the kernel
# with float32 atomics in an order that changes from run to run (reruns
# differ by ~1e-6), the plain version with scatter_add; a bf16 d_field is
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def check_kernel(mode: str, dtype_name: str, shape, timed: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from paradis_torch.ops.interp import interp_plain
    from paradis_torch.ops.interp_cuda import interp_fwd_cuda

    dtype = getattr(torch, dtype_name)
    B, R, C, V, H, W = shape
    field, py, px = interp_inputs(B, R, C, V, H, W, dtype, seed=len(mode) + V)
    out = interp_fwd_cuda(field, py, px, mode)
    ref = interp_plain(field, py, px, mode)
    torch.cuda.synchronize()
    atol, rtol = KERNEL_TOL[dtype_name]
    diff = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    res = {"mode": mode, "dtype": dtype_name, "shape": [B, R, C, V, H, W],
           "max_abs_err": float(diff.max()), "worst_err_over_limit": float((diff / limit).max()),
           "ok": bool((diff <= limit).all()) and out.dtype == dtype
           and bool(torch.isfinite(out).all())}
    if timed:
        res["ms"] = time_ms(lambda: interp_fwd_cuda(field, py, px, mode), iters=200)
        res["plain_ms"] = time_ms(lambda: interp_plain(field, py, px, mode), iters=20)
        # F.grid_sample over [B·V, 1, R, C] with normalised align-corners
        # coordinates: the same function, timed as the library yardstick
        img = field.permute(0, 3, 1, 2).reshape(B * V, 1, R, C).contiguous()
        gx = (px / (C - 1) * 2 - 1).permute(0, 3, 1, 2).reshape(B * V, 1, H * W)
        gy = (py / (R - 1) * 2 - 1).permute(0, 3, 1, 2).reshape(B * V, 1, H * W)
        grid = torch.stack([gx, gy], dim=-1).to(dtype).contiguous()

        def lib():
            return F.grid_sample(img, grid, mode=mode, padding_mode="zeros",
                                 align_corners=True)

        res["library_ms"] = time_ms(lib, iters=50)
        if dtype_name == "float32":
            lib_out = lib().reshape(B, V, H, W).permute(0, 2, 3, 1)
            res["library_max_abs_diff_vs_plain"] = float((lib_out - ref).abs().max())
        res["bound_ms"], res["bound_by"] = bound(field, py, mode)
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
                     integer: bool = False) -> dict:
    """The backward kernel against the plain backward; with ``timed``, its
    time beside the plain backward's, ``F.grid_sample``'s backward and the
    bound."""
    import torch
    import torch.nn.functional as F

    from paradis_torch.ops.interp import interp_bwd_plain
    from paradis_torch.ops.interp_cuda import interp_bwd_cuda

    dtype = getattr(torch, dtype_name)
    B, R, C, V, H, W = shape
    field, py, px = interp_inputs(B, R, C, V, H, W, dtype, seed=len(mode) + V + 1)
    if integer:
        py, px = py.round(), px.round()
    gen = torch.Generator(device="cuda").manual_seed(V)
    g = torch.randn(py.shape, generator=gen, device="cuda").to(dtype)
    out = interp_bwd_cuda(field, py, px, g, mode)
    ref = interp_bwd_plain(field, py, px, g, mode)
    torch.cuda.synchronize()
    res = {"mode": mode, "dtype": dtype_name, "shape": [B, R, C, V, H, W],
           "integer_positions": integer, "max_abs_err": 0.0, "worst_err_over_limit": 0.0,
           "ok": out[0].dtype == dtype}
    for name, o, r in zip(("d_field", "d_py", "d_px"), out, ref):
        atol, rtol = BWD_TOL[dtype_name][name]
        diff = (o.float() - r.float()).abs()
        res[f"{name}_max_abs_err"] = float(diff.max())
        res["max_abs_err"] = max(res["max_abs_err"], float(diff.max()))
        res["worst_err_over_limit"] = max(res["worst_err_over_limit"],
                                          float((diff / (atol + rtol * r.float().abs())).max()))
        res["ok"] = (res["ok"] and bool((diff <= atol + rtol * r.float().abs()).all())
                     and bool(torch.isfinite(o).all()))
    if integer and mode == "bilinear":
        res["ok"] = res["ok"] and not out[1].any() and not out[2].any()
    if timed:
        res["ms"] = time_ms(lambda: interp_bwd_cuda(field, py, px, g, mode), iters=100)
        res["plain_ms"] = time_ms(lambda: interp_bwd_plain(field, py, px, g, mode), iters=10)
        img = field.permute(0, 3, 1, 2).reshape(B * V, 1, R, C).contiguous().requires_grad_()
        gx = (px / (C - 1) * 2 - 1).permute(0, 3, 1, 2).reshape(B * V, 1, H * W)
        gy = (py / (R - 1) * 2 - 1).permute(0, 3, 1, 2).reshape(B * V, 1, H * W)
        grid = torch.stack([gx, gy], dim=-1).to(dtype).contiguous().requires_grad_()
        lib_out = F.grid_sample(img, grid, mode=mode, padding_mode="zeros", align_corners=True)
        g_lib = g.permute(0, 3, 1, 2).reshape(B * V, 1, 1, H * W).contiguous()
        res["library_ms"] = time_ms(
            lambda: torch.autograd.grad(lib_out, (img, grid), g_lib, retain_graph=True), iters=50)
        res["bound_ms"], res["bound_by"] = bound_bwd(field, py, g, mode)
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


def run_forecast(dtype_name: str, card: str) -> dict:
    """40-step full-width rollout; launch counts, finiteness, kernel-vs-plain."""
    import numpy as np
    import torch

    from paradis_torch.config import load_config
    from paradis_torch.forecast import make_forecast_rollout
    from paradis_torch.model import Paradis
    from paradis_torch.ops import interp_cuda
    from paradis_torch.sphere.geometry import equiangular_lat_lon

    dtype = getattr(torch, dtype_name)
    cfg = load_config()
    cfg.forecast.output_frequency = 1
    d = flagship_dims(cfg)
    lat, lon = equiangular_lat_lon(NLAT, NLON, include_poles=False)
    model = Paradis.from_config(cfg, input_dim=d["input_dim"], output_dim=d["n_out"],
                                lat_deg=lat, lon_deg=lon, dtype=dtype, device="cuda")
    n_layers = len(model.layers)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    batch = {
        "input": rng.normal(size=(1, NLAT, NLON, d["n_common"] * d["n_time"])),
        "forcings": rng.normal(size=(1, STEPS, NLAT, NLON, d["n_forcings"] * d["n_time"])),
        "constants": rng.normal(size=(1, NLAT, NLON, d["n_const"])),
    }
    batch = {k: torch.tensor(v, dtype=torch.float32, device="cuda") for k, v in batch.items()}
    rollout = make_forecast_rollout(model, cfg)

    warm = dict(batch, forcings=batch["forcings"][:, :2])
    rollout(warm, d["n_common"])
    torch.cuda.synchronize()

    times, counts, out = [], [], None
    for _ in range(3):
        interp_cuda.launches = 0
        t0 = time.perf_counter()
        out = rollout(batch, d["n_common"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(interp_cuda.launches)
    expected = n_layers * STEPS
    median = sorted(times)[1]
    short = dict(batch, forcings=batch["forcings"][:, :PROFILE_STEPS])
    profile = profile_steps(lambda: rollout(short, d["n_common"]), PROFILE_STEPS,
                            median / STEPS)

    # first step again, routed through the plain interpolation on the card
    model_in = torch.cat([batch["input"], batch["forcings"][:, 0], batch["constants"]], dim=-1)
    with torch.inference_mode():
        model.set_interp_impl("plain")
        before = interp_cuda.launches
        plain = model(model_in).float()
        plain_launches = interp_cuda.launches - before
        model.set_interp_impl("auto")
    torch.cuda.synchronize()
    step_err = float((out[:, 0] - plain).abs().max())
    step_scale = float(plain.abs().max())
    res = {
        "dtype": dtype_name, "card": card, "params": n_params, "layers": n_layers,
        "out_shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
        "out_std": float(out.std()), "launches_per_rollout": counts,
        "expected_launches": expected, "rollout_s": times,
        "forecast_steps_per_s": STEPS / median,
        "first_step_max_abs_diff_vs_plain": step_err, "first_step_max_abs": step_scale,
        "first_step_limit": STEP_TOL[dtype_name] * max(step_scale, 1e-3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile,
    }
    res["ok"] = (res["finite"] and all(c == expected for c in counts) and plain_launches == 0
                 and res["out_shape"] == [1, STEPS, NLAT, NLON, d["n_out"]]
                 and step_err <= res["first_step_limit"] and res["out_std"] > 0)
    del model
    torch.cuda.empty_cache()
    return res


def run_train(dtype_name: str, card: str) -> dict:
    """Full-width train steps: finiteness, loss decrease, launch counts and
    the first step's gradients through the kernels against the plain path."""
    import numpy as np
    import torch

    from paradis_torch.config import load_config
    from paradis_torch.data import dyn_output_features
    from paradis_torch.model import Paradis
    from paradis_torch.ops import interp_cuda
    from paradis_torch.sphere.geometry import equiangular_lat_lon
    from paradis_torch.train import (WeightedLoss, build_optimizer, build_schedule,
                                     create_train_state, make_train_step, set_learning_rate)

    overrides = TRAIN_OVERRIDES + ([] if dtype_name == "bfloat16" else ["compute.use_amp=false"])
    cfg = load_config(overrides=overrides)
    d = flagship_dims(cfg)
    S = int(cfg.model.forecast_steps)
    lat, lon = equiangular_lat_lon(NLAT, NLON, include_poles=False)
    torch.cuda.reset_peak_memory_stats()
    model = Paradis.from_config(cfg, input_dim=d["input_dim"], output_dim=d["n_out"],
                                lat_deg=lat, lon_deg=lon, device="cuda")
    n_layers = len(model.layers)
    loss_fn = WeightedLoss.from_config(cfg, lat, dyn_output_features(cfg.features),
                                       device="cuda")
    optimizer = build_optimizer(cfg, model)
    lr_at, _ = build_schedule(cfg, int(cfg.training.max_steps))
    state = create_train_state(model, optimizer)
    train_step = make_train_step(model, loss_fn, cfg, optimizer)
    rng = np.random.default_rng(0)
    batch = {
        "input": rng.normal(size=(1, NLAT, NLON, d["n_common"] * d["n_time"])),
        "target": rng.normal(size=(1, S, NLAT, NLON, d["n_out"])),
        "forcings": rng.normal(size=(1, S, NLAT, NLON, d["n_forcings"] * d["n_time"])),
        "constants": rng.normal(size=(1, NLAT, NLON, d["n_const"])),
    }
    batch = {k: torch.tensor(v, dtype=torch.float32, device="cuda") for k, v in batch.items()}

    # the first step's parameter gradients, through the plain interpolation
    # and through the kernels (the step's loss at S = 1, unscaled)
    grads, grad_launches = {}, {}
    model_in = torch.cat([batch["input"], batch["forcings"][:, 0], batch["constants"]], dim=-1)
    for impl in ("plain", "auto"):
        model.set_interp_impl(impl)
        optimizer.zero_grad()
        before = (interp_cuda.launches, interp_cuda.bwd_launches)
        loss_fn(model(model_in), batch["target"][:, 0]).backward()
        torch.cuda.synchronize()
        grad_launches[impl] = [interp_cuda.launches - before[0],
                               interp_cuda.bwd_launches - before[1]]
        grads[impl] = torch.cat([p.grad.flatten() for p in optimizer.params])
    model.set_interp_impl("auto")
    optimizer.zero_grad()
    grad_scale = float(grads["plain"].abs().max())
    grad_err = float((grads["auto"] - grads["plain"]).abs().max()) / grad_scale
    del grads

    losses, gnorms, counts, times = [], [], [], []
    for _ in range(TRAIN_STEPS):
        set_learning_rate(optimizer, lr_at(state.step))
        interp_cuda.launches = interp_cuda.bwd_launches = 0
        t0 = time.perf_counter()
        metrics = train_step(state, batch, d["n_common"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append([interp_cuda.launches, interp_cuda.bwd_launches])
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

    expected = n_layers * S
    res = {
        "dtype": dtype_name, "card": card, "model_dtype": str(model.dtype),
        "optimizer": optimizer.name, "ns_dtype": str(optimizer.ns_dtype), "S": S,
        "layers": n_layers, "params": sum(p.numel() for p in model.parameters()),
        "losses": losses, "grad_norms": gnorms, "lrs": [lr_at(i) for i in range(TRAIN_STEPS)],
        "launches_per_step": counts, "expected_launches": expected, "step_s": times,
        "train_steps_per_s": 1.0 / median,
        "first_step_grad_launches": grad_launches,
        "first_step_grad_max_abs": grad_scale, "first_step_grad_rel_err_vs_plain": grad_err,
        "first_step_grad_limit": GRAD_TOL[dtype_name],
        "optimizer_step_wall_ms": opt_s * 1e3, "optimizer_share_of_step_wall": opt_s / median,
        "optimizer_profile": opt_profile,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile,
    }
    res["ok"] = (all(np.isfinite(losses)) and all(np.isfinite(gnorms))
                 and losses[-1] < losses[0]
                 and all(c == [expected, expected] for c in counts)
                 and grad_launches == {"plain": [0, 0], "auto": [expected, expected]}
                 and model.dtype == getattr(torch, dtype_name)
                 and grad_err <= GRAD_TOL[dtype_name])
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

    runs = {}
    for dtype_name in ("float32", "bfloat16"):
        res = run_forecast(dtype_name, card)
        log("[forecast] " + json.dumps(res))
        if not res["ok"]:
            raise SystemExit(f"forecast rollout failed its checks: {res}")
        runs[dtype_name] = res
        log(f"[forecast] {dtype_name}: {res['forecast_steps_per_s']:.2f} steps/s "
            f"({STEPS}-step rollout, batch 1) on {card}")

    trains = {}
    for dtype_name in ("bfloat16", "float32"):
        res = run_train(dtype_name, card)
        log("[train] " + json.dumps(res))
        if not res["ok"]:
            raise SystemExit(f"train steps failed their checks: {res}")
        trains[dtype_name] = res
        log(f"[train] {dtype_name}: {res['train_steps_per_s']:.2f} train steps/s = samples/s "
            f"(batch 1, S = {res['S']}, {res['optimizer']}) on {card}")

    kernels = []
    for c in checks:
        if c["mode"] == "bicubic" and "ms" in c:  # the main path's kernel variants
            kernels.append({
                "name": f"interp_fwd[bicubic,{c['dtype']}]", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": REPLACES,
                "launches": runs[c["dtype"]]["launches_per_rollout"][0],
                "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"]})
    for c in bwd_checks:
        if c["mode"] == "bicubic" and "ms" in c:  # the train path's kernel variants
            kernels.append({
                "name": f"interp_bwd[bicubic,{c['dtype']}]", "route": "cuda",
                "source": BWD_SOURCE, "replaces": BWD_REPLACES,
                "launches": trains[c["dtype"]]["launches_per_step"][0][1],
                "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
