"""Roofline ledger of the flagship train step on an H100.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.roofline [--nlat 128 --nlon 256] [--measure]
        [--cost] [--device cpu] [--steps 4]

The port's counterpart of ``scripts/roofline.py``, rebuilt for the card.
For each named component of the flagship train step (``tools/flagship.py``:
batch 1, bf16 compute, NorMuon with bf16 Newton–Schulz; gradient
checkpointing and the row-banded kernels off the 5.625° grid, as
``bench_highres`` trains it) an analytic inventory of its work, FLOPs and
bytes (each input read once, each output written once), divided by the
card's peaks: the larger of the two times is the floor.

- ``interpolation fwd`` / ``bwd``: the port's kernels #1 / #2 (#5 / #6 at
  1.40625°), ``bound`` and ``bound_bwd`` below (the bound column of
  ``PERF.md``), times their launches a step (the forward 16 under
  checkpointing: 8 and the backward's replay);
- ``NorMuon``: the Newton–Schulz FLOPs of the optimizer's stacks
  (``train/optim.py``: a stack of ``n`` matrices [out, fan] iterates on the
  short side m and the long side k, ``4·m²·k + 2·m³`` a matrix and
  iteration), and its gradient, momentum and parameter traffic;
- ``departure trig``: the departure points' elementwise work and traffic, the
  forward and its backward (and the replay);
- ``1x1 conv GEMMs``: every dense layer (``CLinear`` and the pointwise half
  of ``SepConv``) at its grid, the forward and the two backward products (and
  the replay).

The measured column comes from the card only: ``--measure`` runs
``profile_step``'s source attribution over ``--steps`` steps of the same
train step and reads each component's bucket (the GEMMs: the kernels named
like a GEMM); without it the column says ``not measured``.  ``--cost`` is
the counterpart of XLA's ``cost_analysis()``: one train step on meta tensors
(no card time) under ``torch.utils.flop_counter.FlopCounterMode``, with the
FLOP formulas of the custom ops (``paradis::interp`` / ``interp_bwd``,
``paradis::interp_dense`` / ``interp_dense_bwd``, which it cannot see
inside) from ``flop_formulas``, and the bytes the eager operators read and
write; printed beside the analytic sum.  The JAX script's v5e peaks and
TPU-formulation counts (``V5E``, ``NORMUON_FLOP``) are the reference's own
numbers, printed for comparison only.  Prints the table, then one JSON line.
Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from paradis_torch.tools.flagship import GRID, HR_BAND, device_of, device_record

# ---------------------------------------------------------------- peaks (H100 SXM)
HBM_BW = 3.35e12           # bytes/s
FP32_FLOPS = 67e12         # FLOP/s, CUDA cores
BF16_FLOPS = 989e12        # FLOP/s, dense tensor cores
# the reference's v5e peaks and its count of NorMuon's FLOPs (scripts/roofline.py)
V5E = {"mxu_bf16_flops": 197e12, "vpu_ops": 6.1e12, "hbm_bytes_per_s": 819e9}
NORMUON_FLOP = 1.46e12

# ------------------------------------------------- flagship shapes (scripts/roofline.py)
B, H, W = 1, 32, 64
P = H * W                  # positions per layer
V = 768                    # velocity vectors (each with its own departure point)
PAD = 2                    # bicubic halo
R, C = H + 2 * PAD, W + 2 * PAD
L = 8                      # physics layers
LATENT = 1024

# elementwise operations an element of the departure points, from the JAX
# script's estimates of a transcendental's expansion: sin/cos ~30, asin ~25,
# atan2 ~40, remainder ~6; the fast path's displacement sin/cos degree-7/8
# polynomials (~8 each)
OPS_SINCOS, OPS_ASIN, OPS_ATAN2, OPS_REM = 30, 25, 40, 6
OPS_TRIG_FAST = 4 * 8 + 4 + OPS_ASIN + OPS_ATAN2 + OPS_REM + 15
OPS_TRIG = 2 * OPS_SINCOS * 2 + OPS_ASIN + OPS_ATAN2 + OPS_REM + 15

# kernels (on the CPU, operators) of a GEMM
_GEMM = re.compile(r"gemm|xmma|cutlass|cublas|nvjet|ampere_|sm90_|^aten::(addmm|mm|bmm)$", re.I)


def _floor(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    """(ms, bound_by): the larger of the bytes over the memory rate and the
    operations over ``peak``."""
    bytes_ms = nbytes / HBM_BW * 1e3
    ops_ms = flops / peak * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def interp_flops(n_out: int, mode: str) -> int:
    """Per output: weights (4 cubic polynomials per axis, ~6 flops each, or
    2 linear), one FMA per tap, one FMA per tap row."""
    return n_out * ((2 * 4 * 6 + 16 * 2 + 4 * 2) if mode == "bicubic"
                    else (2 * 2 + 4 * 2 + 2 * 2))


def interp_bwd_flops(n_out: int, mode: str) -> int:
    """Per output: weights and derivatives (4 cubic polynomials each, ~6-8
    flops, per axis; or 2 linear); per tap two FMAs (f·K, f·K′), one product
    g·K·K and its add into d_field; per tap row two FMAs and one product."""
    if mode == "bicubic":
        return n_out * (2 * 4 * (6 + 8) + 16 * 6 + 4 * 5 + 2)
    return n_out * (2 * 2 * (2 + 2) + 4 * 6 + 2 * 5 + 2)


def interp_bound(n_out: int, field_bytes: int, out_size: int, mode: str):
    """The forward's floor: field and both positions (fp32) read once, the
    output (``out_size`` bytes an element) written once."""
    return _floor(field_bytes + 2 * n_out * 4 + n_out * out_size, interp_flops(n_out, mode),
                  FP32_FLOPS)


def interp_bwd_bound(n_out: int, field_bytes: int, g_size: int, mode: str):
    """The backward's floor: field, both positions and g read once; d_field
    (the field's dtype), d_py and d_px (fp32) written once."""
    return _floor(2 * field_bytes + 2 * n_out * 4 + n_out * g_size + 2 * n_out * 4,
                  interp_bwd_flops(n_out, mode), FP32_FLOPS)


def bound(field, py, mode: str):
    """(bound_ms, bound_by) of the forward on these tensors."""
    return interp_bound(py.numel(), field.numel() * field.element_size(),
                        field.element_size(), mode)


def bound_bwd(field, py, g, mode: str):
    """(bound_ms, bound_by) of the backward on these tensors and cotangent."""
    return interp_bwd_bound(py.numel(), field.numel() * field.element_size(),
                            g.element_size(), mode)


def _interp_formula(field_shape, pix_y_shape, pix_x_shape, mode, *args, **kwargs) -> int:
    return interp_flops(torch.Size(pix_y_shape).numel(), mode)


def _interp_bwd_formula(field_shape, pix_y_shape, pix_x_shape, g_shape, mode, *args,
                        **kwargs) -> int:
    return interp_bwd_flops(torch.Size(pix_y_shape).numel(), mode)


def _dense_formula(field_shape, pix_y_shape, *args, **kwargs) -> int:
    Bf, Rf, Cf, Vf = field_shape
    n = torch.Size(pix_y_shape).numel()       # B·P·V
    return 2 * n * Rf * Cf + 2 * n * Cf       # the row contraction, then the columns


def _dense_bwd_formula(field_shape, pix_y_shape, *args, **kwargs) -> int:
    Bf, Rf, Cf, Vf = field_shape
    n = torch.Size(pix_y_shape).numel()
    return 3 * 2 * n * Rf * Cf + 2 * n * (Rf + Cf)   # d_field, t, u; the two reductions


def flop_formulas() -> dict:
    """``FlopCounterMode``'s ``custom_mapping`` for the port's custom ops (it
    counts nothing inside an op it has no formula for)."""
    from paradis_torch.ops import interp_cuda, interp_dense  # noqa: F401  (registers the ops)

    ops = torch.ops.paradis
    return {ops.interp: _interp_formula, ops.interp_bwd: _interp_bwd_formula,
            ops.interp_dense: _dense_formula, ops.interp_dense_bwd: _dense_bwd_formula}


def _config(grid, overrides=()):
    from paradis_torch.config import load_config

    hr = [] if tuple(grid) == GRID else ["compute.gradient_checkpointing=true", *HR_BAND]
    return load_config(overrides=["training.optimizer.name=normuon", *hr, *overrides])


def ns_flops(optimizer) -> tuple[int, int, list]:
    """Newton–Schulz FLOPs of one update over the optimizer's stacks, the
    bytes of its gradient, momentum and parameter traffic (fp32: the
    gradient read, momentum and parameter read and written), and the stacks
    ``[n, out, fan]``."""
    steps = int(optimizer.ns_steps)
    flops, nbytes, stacks = 0, 0, []
    for g in optimizer.muon_groups:
        n, m, k = len(g.params), min(g.out, g.fan), max(g.out, g.fan)
        flops += n * steps * (4 * m * m * k + 2 * m ** 3)
        nbytes += n * g.out * g.fan * 4 * 5
        stacks.append([n, g.out, g.fan])
    return flops, nbytes, stacks


def dense_layers(model) -> list:
    """``(name, in, out, positions)`` of every dense layer (``_Dense``) of the
    model at the grid it runs on."""
    from paradis_torch.ops.blocks import _Dense

    Hf, Wf = model.mesh_size
    Hc, Wc = model.mesh_size_coarse
    return [(name, m.weight.shape[1], m.weight.shape[0],
             Hc * Wc if name.startswith("layers.") else Hf * Wf)
            for name, m in model.named_modules() if isinstance(m, _Dense)]


def ledger(grid, overrides=()) -> dict:
    """The analytic inventory of each component of one train step on
    ``grid``: its FLOPs, bytes, floor (ms) and what bounds it."""
    from paradis_torch.tools.flagship import flagship
    from paradis_torch.train import build_optimizer

    cfg = _config(grid, overrides)
    model, d = flagship(cfg, grid, "meta", dtype=None)
    optimizer = build_optimizer(cfg, model)
    Hc, Wc = model.mesh_size_coarse
    layers = len(model.layers)
    V_ = int(cfg.model.velocity_vectors)
    mode = model.layers[0].advection.interpolation
    pad = 2 if mode == "bicubic" else 1
    replay = 2 if model.gradient_checkpointing else 1
    cdt = 2 if model.dtype == torch.bfloat16 else 4
    peak = BF16_FLOPS if cdt == 2 else FP32_FLOPS
    n_out = Hc * Wc * V_
    field = (Hc + 2 * pad) * (Wc + 2 * pad) * V_ * cdt
    comp = {}

    f_ms, f_by = interp_bound(n_out, field, cdt, mode)
    comp["interpolation fwd"] = {"launches": layers * replay, "ms": layers * replay * f_ms,
                                 "bound_by": f_by, "launch_ms": f_ms,
                                 "flops": layers * replay * interp_flops(n_out, mode)}
    b_ms, b_by = interp_bwd_bound(n_out, field, cdt, mode)
    comp["interpolation bwd"] = {"launches": layers, "ms": layers * b_ms, "bound_by": b_by,
                                 "launch_ms": b_ms, "flops": layers * interp_bwd_flops(n_out, mode)}

    ns, ns_bytes, stacks = ns_flops(optimizer)
    ms, by = _floor(ns_bytes, ns, BF16_FLOPS if str(optimizer.ns_dtype).endswith("bfloat16")
                    else FP32_FLOPS)
    comp["NorMuon update"] = {"ms": ms, "bound_by": by, "flops": ns, "bytes": ns_bytes,
                              "stacks": stacks, "reference_flops_v5e": NORMUON_FLOP}

    ops = OPS_TRIG_FAST if model.layers[0].advection.fast_trig else OPS_TRIG
    E = B * Hc * Wc * V_
    trig_ops = layers * E * ops * (replay + 1)        # forward (and replay), backward ~ same
    trig_bytes = layers * E * ((2 * cdt + 2 * 4) * replay + (2 * 4 + 2 * cdt + 2 * cdt))
    ms, by = _floor(trig_bytes, trig_ops, FP32_FLOPS)
    comp["departure trig"] = {"ms": ms, "bound_by": by, "flops": trig_ops, "bytes": trig_bytes}

    gemm_flops = gemm_bytes = 0
    dense = dense_layers(model)
    for name, n_in, n_o, pos in dense:
        times = replay if name.startswith("layers.") else 1
        gemm_flops += 2 * B * pos * n_in * n_o * (times + 2)
        gemm_bytes += ((B * pos * (n_in + n_o) * cdt + n_in * n_o * cdt) * (times + 2)
                       + n_in * n_o * 4)
    ms, by = _floor(gemm_bytes, gemm_flops, peak)
    comp["1x1 conv GEMMs"] = {"ms": ms, "bound_by": by, "flops": gemm_flops,
                              "bytes": gemm_bytes, "layers": len(dense)}
    total_flops = sum(c["flops"] for c in comp.values())
    return {"grid": list(grid), "dtype": str(model.dtype).removeprefix("torch."),
            "gradient_checkpointing": model.gradient_checkpointing,
            "band_px": model.band_max_dy_pix, "params": sum(p.numel() for p in model.parameters()),
            "components": comp, "analytic_flops": total_flops}


class _BytesMode(torch.utils._python_dispatch.TorchDispatchMode):
    """The bytes each operator reads (its tensor inputs) and writes (its
    tensor outputs), views left out."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            leaves = torch.utils._pytree.tree_leaves((args, kwargs or {}, out))
            self.bytes += sum(t.numel() * t.element_size() for t in leaves
                              if isinstance(t, torch.Tensor))
        return out


def cost(grid, overrides=()) -> dict:
    """One train step of the flagship on ``grid`` on meta tensors under
    ``FlopCounterMode`` (with ``flop_formulas``) and ``_BytesMode``: FLOPs,
    FLOPs by operator, bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    from paradis_torch.tools.bench_highres import train_setup

    run = train_setup(_config(grid, overrides), grid, "meta")
    with FlopCounterMode(display=False, custom_mapping=flop_formulas()) as fc, \
            _BytesMode() as bm:
        run["step"]()
    by_op = {str(k): v for k, v in fc.get_flop_counts().get("Global", {}).items()}
    return {"flops": fc.get_total_flops(), "flops_by_op": by_op, "bytes": bm.bytes}


def measure(grid, device, steps: int, overrides=()) -> dict:
    """Each component's ms a step from ``profile_step``'s source buckets on
    ``device`` (the GEMMs from the kernels' names), the step's total, and
    the buckets."""
    from paradis_torch.tools.bench_highres import train_setup
    from paradis_torch.tools.flagship import sync
    from paradis_torch.tools.profile_step import source_profile

    run = train_setup(_config(grid, overrides), grid, device)
    for _ in range(4):
        run["step"]()
    sync(device)

    def traced():
        for _ in range(steps):
            run["step"]()

    prof = source_profile(traced, steps, device)
    src = prof["by_source"]

    def get(*keys):
        return sum(src.get(k, 0.0) for k in keys)

    meas = {"interpolation fwd": get("interpolation", "replay: interpolation"),
            "interpolation bwd": get("backward: interpolation"),
            "NorMuon update": get("optimizer"),
            "departure trig": get("departure", "replay: departure", "backward: departure"),
            "1x1 conv GEMMs": sum(ms for (source, name), ms in prof["pairs"].items()
                                  if _GEMM.search(name) and source != "optimizer")}
    meas["tail (everything else)"] = prof["ms_per_step"] - sum(meas.values())
    return {"ms": meas, "step_ms": prof["ms_per_step"], "by_source": src}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nlat", type=int, default=GRID[0])
    ap.add_argument("--nlon", type=int, default=GRID[1])
    ap.add_argument("--measure", action="store_true",
                    help="measure each component on the device (profile_step)")
    ap.add_argument("--cost", action="store_true",
                    help="count the whole step's FLOPs and bytes (FlopCounterMode, meta tensors)")
    ap.add_argument("--steps", type=int, default=4, help="traced steps of --measure")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (repeatable)")
    args = ap.parse_args(argv)
    device = device_of(args.device, "roofline")
    grid = (args.nlat, args.nlon)
    led = ledger(grid, args.override)
    meas = measure(grid, device, args.steps, args.override) if args.measure else None

    print(f"## Roofline ledger — flagship train step, batch 1, {grid[0]}x{grid[1]}, "
          f"{led['dtype']}, H100 peaks (HBM {HBM_BW / 1e12} TB/s, fp32 {FP32_FLOPS / 1e12:.0f} "
          f"/ bf16 {BF16_FLOPS / 1e12:.0f} TFLOP/s)")
    print()
    print("| component | measured | floor | ach. floor/meas | bound by | verdict |")
    print("|---|---|---|---|---|---|")
    for name, c in led["components"].items():
        m = meas["ms"][name] if meas else None
        ratio = f"{100.0 * c['ms'] / m:5.1f}%" if m else "-"
        print(f"| {name:<20} | {f'{m:9.3f} ms' if m is not None else 'not measured'} | "
              f"{c['ms']:9.4g} ms | {ratio} | {c['bound_by']} | {c['flops'] / 1e9:.1f} GFLOP |")
    if meas:
        print(f"| tail (everything else) | {meas['ms']['tail (everything else)']:9.3f} ms | "
              f"- | - | - | step {meas['step_ms']:.3f} ms |")
    res = dict(led, measured=meas, peaks={"hbm_bytes_per_s": HBM_BW, "fp32_flops": FP32_FLOPS,
                                          "bf16_flops": BF16_FLOPS},
               reference_v5e=V5E, **device_record(device))
    if args.cost:
        res["cost"] = cost(grid, args.override)
        fl = res["cost"]["flops"]
        print()
        print(f"whole step (FlopCounterMode, meta tensors): {fl / 1e9:.1f} GFLOP "
              f"-> {fl / BF16_FLOPS * 1e3:.3f} ms at bf16 peak; analytic sum "
              f"{led['analytic_flops'] / 1e9:.1f} GFLOP; eager operators' bytes "
              f"{res['cost']['bytes'] / 2 ** 30:.2f} GiB -> "
              f"{res['cost']['bytes'] / HBM_BW * 1e3:.3f} ms at HBM peak")
    print(json.dumps(res, default=float), flush=True)
    return res


if __name__ == "__main__":
    main()
