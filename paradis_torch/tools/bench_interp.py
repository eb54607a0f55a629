"""The port's interpolation microbenchmark, on the card.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.bench_interp [--variants a,b] [--device cpu]
        [--shape B,H,W,V] [--iters N] [--repeats N] [--override key=value ...]

The port's counterpart of ``scripts/bench_interp.py``, at its shapes and
inputs: positions [1, 32, 64, 768] on the padded 36 × 68 grid (pad 2),
bicubic, a bfloat16 field, drawn from ``default_rng(0)`` as there.  Variants:

- ``xla_fwd`` / ``xla_fwdbwd``: the JAX package's dense path
  (``interpolate(..., impl="xla")``, ``ops/interp_dense.py``, plain torch);
- ``cuda_fwd`` / ``cuda_fwdbwd``: the interpolation forward, and forward
  plus the gradients of the output's sum with respect to field and
  positions, through ``ops/advection.interpolate`` (the kernels
  ``csrc/interp_fwd.cu`` and ``csrc/interp_bwd.cu``);
- ``chunked_fwd`` / ``chunked_fwdbwd``: the same through the row-chunked
  kernels at ``chunk_rows=8``;
- ``genonly`` / ``bwd_genonly``: the tap weights alone, and with their
  derivatives (``csrc/interp_gen.cu``), to split the gather kernels into
  weight arithmetic and memory;
- ``mm_f32_vb8``, ``mm_bf16_vb8``, ``mm_bf16_vb32``, ``mm_bf16_vb128``,
  ``mmT_bf16_vb8``: the dense forward's contraction alone
  (``csrc/interp_mm.cu``), float32 or bfloat16 operands, channel blocks of
  8 / 32 / 128 planes with position blocks of 1024 / 256 / 128, on wx
  [B, V, P, C] (``mmT``: wxT [B, V, C, P]) and f [B, V, R, C] normal from
  ``default_rng(1)``, as there;
- ``bwd_mmonly``: the dense backward's contractions with stand-in weights
  (``csrc/interp_mm.cu``) on the bench's field and positions, channel-major,
  with g = 1;
- ``ns_update``: one NorMuon update on gradients shaped like the flagship's
  (``configs/default.yaml`` with ``--override``s, on the positions' grid,
  gradients normal with scale 1e-2 from ``default_rng(1)``).

Each variant is timed with CUDA events over ``--iters`` calls after a
warm-up, the median of ``--repeats`` such runs, in ms per call.  Prints one
line per variant, then one JSON line with the times, the kernel launches of
one call of each variant and of its whole run (the call, the warm-up and the
timed calls), the card and the shapes.  It runs on the card unless given
``--device cpu``, which runs the plain versions (host clock, for the CPU
test); without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from paradis_torch import resolve_device

SHAPE = (1, 32, 64, 768)   # B, H, W, V
PAD = 2
MODE = "bicubic"
CHUNK_ROWS = 8
VARIANTS = ("xla_fwd", "xla_fwdbwd", "cuda_fwd", "cuda_fwdbwd", "chunked_fwd",
            "chunked_fwdbwd", "genonly", "mm_f32_vb8", "mm_bf16_vb8", "mm_bf16_vb32",
            "mm_bf16_vb128", "mmT_bf16_vb8", "bwd_genonly", "bwd_mmonly", "ns_update")
# the contraction variants: operand dtype, channel block, position block
MM_VARIANTS = {"mm_f32_vb8": (torch.float32, 8, 1024), "mm_bf16_vb8": (torch.bfloat16, 8, 1024),
               "mm_bf16_vb32": (torch.bfloat16, 32, 256),
               "mm_bf16_vb128": (torch.bfloat16, 128, 128),
               "mmT_bf16_vb8": (torch.bfloat16, 8, 1024)}


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def launch_counts() -> dict[str, int]:
    """The launch counters of every interpolation kernel wrapper."""
    from paradis_torch.ops import interp_cuda as ic
    from paradis_torch.ops import interp_gen as ig
    from paradis_torch.ops import interp_mm as im

    return {"interp_fwd": ic.launches, "interp_bwd": ic.bwd_launches,
            "interp_band_fwd": ic.band_launches, "interp_band_bwd": ic.band_bwd_launches,
            "interp_chunk_fwd": ic.chunk_launches, "interp_chunk_bwd": ic.chunk_bwd_launches,
            "interp_gen": ig.gen_launches, "interp_bwd_gen": ig.bwd_gen_launches,
            "interp_mm": im.mm_launches, "interp_mmT": im.mmT_launches,
            "interp_bwd_mm": im.bwd_mm_launches}


def inputs(shape, device):
    """Field (bf16) and in-field positions of the padded grid, as
    ``scripts/bench_interp.py:_inputs`` draws them."""
    B, H, W, V = shape
    R, C = H + 2 * PAD, W + 2 * PAD
    rng = np.random.default_rng(0)
    field = torch.from_numpy(rng.normal(size=(B, R, C, V))).to(torch.bfloat16)
    py = torch.from_numpy(rng.uniform(PAD, H - 1 + PAD, size=(B, H, W, V)).astype(np.float32))
    px = torch.from_numpy(rng.uniform(PAD, W - 1 + PAD, size=(B, H, W, V)).astype(np.float32))
    return field.to(device), py.to(device), px.to(device)


def channel_major(x: torch.Tensor) -> torch.Tensor:
    """[B, ..., V] → contiguous [B, V, ...] (the TPU bench's ``moveaxis``)."""
    return torch.movedim(x, -1, 1).contiguous()


def interp_variants(shape, device) -> dict:
    """The interpolation, weight-generation and dense-backward variants,
    each a call."""
    from paradis_torch.ops.advection import interpolate
    from paradis_torch.ops.interp_gen import bwd_gen, gen
    from paradis_torch.ops.interp_mm import bwd_mm

    field, py, px = inputs(shape, device)
    B, R, C, V = field.shape
    leaves = [t.clone().requires_grad_() for t in (field, py, px)]
    field_t = channel_major(field)
    py_t, px_t = (channel_major(t.reshape(B, -1, V)) for t in (py, px))
    g_t = torch.ones_like(py_t)

    def fwd(impl, rw=0):
        return lambda: interpolate(field, py, px, MODE, impl, chunk_rows=rw)

    def fwdbwd(impl, rw=0):
        def run():
            out = interpolate(*leaves, MODE, impl, chunk_rows=rw)
            return torch.autograd.grad(out.float().sum(), leaves)
        return run

    return {"xla_fwd": fwd("xla"), "xla_fwdbwd": fwdbwd("xla"),
            "cuda_fwd": fwd("auto"), "cuda_fwdbwd": fwdbwd("auto"),
            "chunked_fwd": fwd("auto", CHUNK_ROWS), "chunked_fwdbwd": fwdbwd("auto", CHUNK_ROWS),
            "genonly": lambda: gen(py, px, R, C, MODE),
            "bwd_genonly": lambda: bwd_gen(py, px, R, C, MODE),
            "bwd_mmonly": lambda: bwd_mm(field_t, py_t, px_t, g_t, torch.bfloat16)}


def mm_operands(shape, device, transposed: bool):
    """wx [B, V, P, C] (wxT [B, V, C, P]) and f [B, V, R, C], float32 normal
    from a fresh ``default_rng(1)`` in that order, as ``scripts/bench_interp.py``
    draws them for ``mm_only`` (``mmT_only``)."""
    B, H, W, V = shape
    R, C, P = H + 2 * PAD, W + 2 * PAD, H * W
    rng = np.random.default_rng(1)
    w = rng.normal(size=(B, V, C, P) if transposed else (B, V, P, C)).astype(np.float32)
    f = rng.normal(size=(B, V, R, C)).astype(np.float32)
    return torch.from_numpy(w).to(device), torch.from_numpy(f).to(device)


def mm_variants(shape, device, names) -> dict:
    """The contraction variants among ``names``, each a call; their operands
    are drawn only when asked for (428 MB of wx at the bench's shapes)."""
    from paradis_torch.ops.interp_mm import mm, mmT

    calls, operands = {}, {}
    for name in names:
        if name not in MM_VARIANTS:
            continue
        cdt, vb, pb = MM_VARIANTS[name]
        transposed = name.startswith("mmT")
        if transposed not in operands:
            operands[transposed] = mm_operands(shape, device, transposed)
        w, f = operands[transposed]
        calls[name] = functools.partial(mmT if transposed else mm, w, f, cdt, vb, pb)
    return calls


def ns_variant(shape, device, overrides=()):
    """One NorMuon update of the flagship's parameters on seeded gradients."""
    from paradis_torch.config import load_config
    from paradis_torch.model import Paradis
    from paradis_torch.sphere.geometry import equiangular_lat_lon
    from paradis_torch.train import build_optimizer

    cfg = load_config(overrides=list(overrides))
    cfg.training.optimizer.name = "normuon"
    f = cfg.features
    n_levels = len(f.pressure_levels)
    n_common = len(f.input.atmospheric) * n_levels + len(f.input.surface)
    n_out = len(f.output.atmospheric) * n_levels + len(f.output.surface)
    n_time = int(cfg.dataset.n_time_inputs)
    input_dim = (n_common + len(f.input.forcings)) * n_time + len(f.input.constants)
    lat, lon = equiangular_lat_lon(shape[1], shape[2], include_poles=False)
    model = Paradis.from_config(cfg, input_dim=input_dim, output_dim=n_out, lat_deg=lat,
                                lon_deg=lon, device=device)
    rng = np.random.default_rng(1)
    for p in model.parameters():
        p.grad = torch.from_numpy(rng.normal(size=tuple(p.shape), scale=1e-2)).to(
            device=device, dtype=p.dtype)
    return build_optimizer(cfg, model).step


def time_ms(fn, device: torch.device, iters: int, repeats: int, warmup: int) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` calls: CUDA
    events on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(runs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="all",
                    help=f"comma-separated subset of {','.join(VARIANTS)}")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)), help="B,H,W,V")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--override", action="append", default=[],
                    help="config override for ns_update (repeatable)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    shape = tuple(int(n) for n in args.shape.split(","))
    names = VARIANTS if args.variants == "all" else tuple(args.variants.split(","))
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {list(VARIANTS)}")

    calls = interp_variants(shape, device)
    calls.update(mm_variants(shape, device, names))
    if "ns_update" in names:
        calls["ns_update"] = ns_variant(shape, device, args.override)
    ms, launches, in_run = {}, {}, {}
    for name in names:
        fn = calls[name]
        before = launch_counts()
        fn()
        launches[name] = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        ms[name] = time_ms(fn, device, args.iters, args.repeats, args.warmup)
        in_run[name] = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        print(f"{name:16s} {ms[name]:10.4f} ms/op", flush=True)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    res = {"ms_per_op": ms, "launches_per_op": launches, "launches_per_run": in_run,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind},
           "card": card_line() if device.type == "cuda" else None,
           "shape": list(shape), "pad": PAD, "mode": MODE, "field_dtype": "bfloat16",
           "chunk_rows": CHUNK_ROWS, "iters": args.iters, "repeats": args.repeats}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
