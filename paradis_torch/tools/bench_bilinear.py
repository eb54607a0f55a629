"""The bilinear route's kernels on the card, beside ``F.grid_sample`` and, in
turns, another checkout's kernels.

Usage (from the root of a checkout, on a card):

    python3 -m paradis_torch.tools.bench_bilinear [--other DIR ...] [--history DIR ...]
        [--rounds 2] [--out FILE]

Every bilinear entry point launches the route of
``paradis_torch/csrc/interp_bilinear.cuh``.  On ``chip_smoke.py``'s bilinear
inputs (its seeds and shapes: the 5.625° field [1, 34, 66, 768] with
positions [1, 32, 64, 768], raw for #1 and #2 and clamped to the
``compute.interp_band_rad=0.3`` bound for #3 and #4; the 1.40625° field
[1, 130, 258, 768] with positions [1, 128, 256, 768] clamped to its bound for
all six; float32 and bfloat16), and on two blocks of the spatial layouts
(the 1.40625° field gathered whole, the clamped positions of one rank's
block: rows 64-127 of a 2-way ``lat_devices`` split, and rows 64-127 by
columns 128-255 of a 2 × 2 one; #1 and #2), it holds the route against the
plain versions (``chip_smoke.py``'s tolerances) and across entry points
(bitwise: the forward, d_py and d_px), and times each entry point with CUDA
events (the calls queued behind a spin kernel, as ``chip_smoke.py`` times).
Beside #1 and #2, ``lib``: ``F.grid_sample`` (or its backward) on planes
[B·V, 1, R, C], as the smoke times it, and ``lib_layout``: the same from and
to the port's channels-last layout.  The bicubic kernels are timed too, #1
and #2 at 5.625°, #5 and #6 at 1.40625°.

Each round runs the checkout's kernels in a process of their own, and with
``--other DIR`` (another checkout, for example ``git archive <commit> | tar
-x -C DIR``; repeatable) that checkout's in another, in turns (round r in
order, the next reversed; the mean of ``--rounds``), on the same inputs
through the same Python wrappers, its times under keys prefixed with the
directory's name; their outputs must be bitwise the same (the forward, d_py
and d_px, bilinear and bicubic).  ``--history DIR`` times a checkout from
further back the same way, for kernels that summed in another float order:
whether its bits agree is recorded, not required.  Prints one JSON line a
case, then a summary line; ``--out`` writes them all as one JSON list.
Without a card it raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ROUNDS = 2
V = 768
LR, HR = (32, 64), (128, 256)
CHUNK_RW = {LR: 8, HR: 32}  # chip_smoke.py's CHUNK_RW and HR_CHUNK_RW
BAND_RAD = 0.3
SPIN_CYCLES_PER_S = 2.0e9   # torch.cuda._sleep cycles a second, at or above the SM clock
MAX_QUEUE_S = 0.25          # the longest spin time_ms queues its calls behind
# chip_smoke.py's KERNEL_TOL and BWD_TOL
KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 1e-5 + 2.0 ** -7)}
BWD_TOL = {
    "float32": {"d_field": (2e-5, 1e-5), "d_py": (3e-5, 1e-5), "d_px": (3e-5, 1e-5)},
    "bfloat16": {"d_field": (2e-5, 1e-5 + 2.0 ** -7), "d_py": (3e-5, 1e-5),
                 "d_px": (3e-5, 1e-5)},
}


def cases() -> list[dict]:
    """Every case: its id, forward or backward, mode, dtype, arrival grid, the
    block of it whose positions are taken (rows, columns), whether they are
    clamped to the band, and the entry points timed ((label, kernel))."""
    out = []
    for dtype in ("float32", "bfloat16"):
        for kind in ("fwd", "bwd"):
            t = ("t1", "t3", "t5") if kind == "fwd" else ("t2", "t4", "t6")
            k = (("interp_fwd", "interp_chunk_fwd", "interp_band_fwd") if kind == "fwd"
                 else ("interp_bwd", "interp_chunk_bwd", "interp_band_bwd"))
            for grid, clamp, timed in ((LR, False, [(t[0], k[0])]),
                                       (LR, True, [(t[1], k[1])]),
                                       (HR, True, list(zip(t, k)))):
                out.append({"kind": kind, "mode": "bilinear", "dtype": dtype, "grid": grid,
                            "block": (0, grid[0], 0, grid[1]), "clamp": clamp,
                            "timed": timed})
            for block in ((64, 128, 0, 256), (64, 128, 128, 256)):
                out.append({"kind": kind, "mode": "bilinear", "dtype": dtype, "grid": HR,
                            "block": block, "clamp": True, "timed": [(t[0], k[0])]})
            for grid, clamp, i in ((LR, False, 0), (HR, True, 2)):
                out.append({"kind": kind, "mode": "bicubic", "dtype": dtype, "grid": grid,
                            "block": (0, grid[0], 0, grid[1]), "clamp": clamp,
                            "timed": [(t[i], k[i])]})
    for c in out:
        r0, r1, c0, c1 = c["block"]
        c["id"] = (f"{c['kind']} {c['mode']} {c['dtype']} {c['grid'][0]}x{c['grid'][1]}"
                   f"{' clamped' if c['clamp'] else ''}"
                   f"{'' if (r1 - r0, c1 - c0) == c['grid'] else f' block {r0}:{r1},{c0}:{c1}'}")
    return out


def bound(case: dict) -> tuple[float, str]:
    """(bound_ms, bound_by) of the case (``tools/roofline``'s formulas)."""
    from paradis_torch.tools.roofline import interp_bound, interp_bwd_bound

    pad = 1 if case["mode"] == "bilinear" else 2
    r0, r1, c0, c1 = case["block"]
    size = 4 if case["dtype"] == "float32" else 2
    n_out = (r1 - r0) * (c1 - c0) * V
    field = (case["grid"][0] + 2 * pad) * (case["grid"][1] + 2 * pad) * V * size
    if case["kind"] == "fwd":
        return interp_bound(n_out, field, size, case["mode"])
    return interp_bwd_bound(n_out, field, size, case["mode"])


def time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), queued behind a spin kernel that lasts as long as the host
    takes to enqueue them, so that the card's time is measured, not the
    host's."""
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


def inputs(case: dict):
    """The case's field, positions (and band plan, and cotangent): the field
    padded by the mode's pad, positions at the block's arrival points plus
    pad plus ~1.5 px, 5% anywhere up to 3 px outside the field (chip_smoke's
    ``interp_inputs``), clamped to ±bound px of their arrival row where the
    case says (its ``band_inputs``)."""
    import torch

    from paradis_torch.model.paradis import band_bound_pixels
    from paradis_torch.ops.interp_band import band_spec
    from paradis_torch.sphere.geometry import equiangular_lat_lon

    mode, dtype = case["mode"], getattr(torch, case["dtype"])
    pad = 1 if mode == "bilinear" else 2
    (H, W), (r0, r1, c0, c1) = case["grid"], case["block"]
    R, C, h, w = H + 2 * pad, W + 2 * pad, r1 - r0, c1 - c0
    seed = len(mode) + V + (case["kind"] == "bwd" and mode == "bilinear")
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    field = torch.randn(1, R, C, V, generator=g, device=dev).to(dtype)
    ay = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1, 1) + r0 + pad
    ax = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w, 1) + c0 + pad
    py = ay + 1.5 * torch.randn(1, h, w, V, generator=g, device=dev)
    px = ax + 1.5 * torch.randn(1, h, w, V, generator=g, device=dev)
    wild = torch.rand(1, h, w, V, generator=g, device=dev) < 0.05
    py = torch.where(wild, torch.rand(1, h, w, V, generator=g, device=dev) * (R + 5) - 3, py)
    px = torch.where(wild, torch.rand(1, h, w, V, generator=g, device=dev) * (C + 5) - 3, px)
    spec = None
    if case["clamp"]:
        px_bound = band_bound_pixels(BAND_RAD, equiangular_lat_lon(H, W, include_poles=False)[0])
        py = torch.clamp(py, ay - px_bound, ay + px_bound)
        if (h, w) == (H, W):
            spec = band_spec(H, W, R, mode, px_bound)
    grad = None
    if case["kind"] == "bwd":
        grad = torch.randn(py.shape, generator=torch.Generator(device=dev).manual_seed(V),
                           device=dev).to(dtype)
    return field, py.contiguous(), px.contiguous(), spec, grad


def grid_sample_args(field, py, px):
    """``F.grid_sample``'s arguments for the same function: the field as
    [B·V, 1, R, C] and normalised align-corners coordinates."""
    import torch

    B, R, C, Vf = field.shape
    _, H, W, _ = py.shape
    img = field.permute(0, 3, 1, 2).reshape(B * Vf, 1, R, C).contiguous()
    gx = (px / (C - 1) * 2 - 1).permute(0, 3, 1, 2).reshape(B * Vf, 1, H * W)
    gy = (py / (R - 1) * 2 - 1).permute(0, 3, 1, 2).reshape(B * Vf, 1, H * W)
    return img, torch.stack([gx, gy], dim=-1).to(field.dtype).contiguous()


def library_calls(field, py, px, grad) -> dict:
    """``lib`` and ``lib_layout``: ``F.grid_sample``, or its backward, on
    planes, and from and to the port's layout."""
    import torch
    import torch.nn.functional as F

    B, R, C, Vf = field.shape
    _, H, W, _ = py.shape

    def sample(img, grid):
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    img, grid = grid_sample_args(field, py, px)
    if grad is None:
        def layout():
            out = sample(*grid_sample_args(field, py, px))
            return out.reshape(B, Vf, H, W).permute(0, 2, 3, 1).contiguous()
        return {"lib": lambda: sample(img, grid), "lib_layout": layout}
    img.requires_grad_()
    grid.requires_grad_()
    out = sample(img, grid)
    g_planes = grad.permute(0, 3, 1, 2).reshape(B * Vf, 1, 1, H * W).contiguous()

    def layout():
        g_lib = grad.permute(0, 3, 1, 2).reshape(B * Vf, 1, 1, H * W).contiguous()
        d_img, d_grid = torch.autograd.grad(out, (img, grid), g_lib, retain_graph=True)
        d = d_grid.reshape(B, Vf, H, W, 2).float()
        return (d_img.reshape(B, Vf, R, C).permute(0, 2, 3, 1).contiguous(),
                (d[..., 1] * (2.0 / (R - 1))).permute(0, 2, 3, 1).contiguous(),
                (d[..., 0] * (2.0 / (C - 1))).permute(0, 2, 3, 1).contiguous())
    return {"lib": lambda: torch.autograd.grad(out, (img, grid), g_planes, retain_graph=True),
            "lib_layout": layout}


def _within(got, ref, atol, rtol) -> tuple[bool, float]:
    diff = (got.float() - ref.float()).abs()
    return bool((diff <= atol + rtol * ref.float().abs()).all()), float(diff.max())


def _digest(*tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def run_case(case: dict, lib: bool) -> dict:
    """One case on this process's checkout: its checks, the digest of its
    outputs and the ms of each timed entry point (and with ``lib`` of the
    library's calls)."""
    import torch

    from paradis_torch.ops import interp_cuda as ic
    from paradis_torch.ops.interp import interp_bwd_plain, interp_plain
    from paradis_torch.ops.interp_band import interp_band_bwd_plain, interp_band_plain

    f, y, x, spec, g = inputs(case)
    mode, name = case["mode"], case["dtype"]
    rw = CHUNK_RW[tuple(case["grid"])]
    rec = {"id": case["id"], "ok": True}
    if case["kind"] == "fwd":
        calls = {"interp_fwd": lambda: ic.interp_fwd_cuda(f, y, x, mode),
                 "interp_chunk_fwd": lambda: ic.interp_chunk_fwd_cuda(f, y, x, rw, mode),
                 "interp_band_fwd": lambda: ic.interp_band_fwd_cuda(f, y, x, spec, mode)}
        out = calls["interp_fwd"]()
        rec["route"] = ic.interp_fwd_route(f, mode)
        rec["ok"], rec["max_abs_err"] = _within(out, interp_plain(f, y, x, mode),
                                                *KERNEL_TOL[name])
        others = [calls["interp_chunk_fwd"]()]
        if spec is not None:
            others.append(calls["interp_band_fwd"]())
            rec["ok"] = rec["ok"] and _within(others[-1], interp_band_plain(f, y, x, spec, mode),
                                              *KERNEL_TOL[name])[0]
        rec["bitwise_equal_entries"] = all(torch.equal(out, o) for o in others)
        rec["digest"] = _digest(out)
        iters = 200 if y.numel() < 5_000_000 else 40
    else:
        calls = {"interp_bwd": lambda: ic.interp_bwd_cuda(f, y, x, g, mode),
                 "interp_chunk_bwd": lambda: ic.interp_chunk_bwd_cuda(f, y, x, g, rw, mode),
                 "interp_band_bwd": lambda: ic.interp_band_bwd_cuda(f, y, x, g, spec, mode)}
        out = calls["interp_bwd"]()
        refs = [(out, interp_bwd_plain(f, y, x, g, mode))]
        others = [calls["interp_bwd"](), calls["interp_chunk_bwd"]()]
        if spec is not None:
            others.append(calls["interp_band_bwd"]())
            refs.append((others[-1], interp_band_bwd_plain(f, y, x, g, spec, mode)))
        for got, ref in refs:
            for n, a, b in zip(("d_field", "d_py", "d_px"), got, ref):
                ok, err = _within(a, b, *BWD_TOL[name][n])
                rec["ok"] = rec["ok"] and ok
                rec[f"{n}_max_abs_err"] = max(rec.get(f"{n}_max_abs_err", 0.0), err)
        rec["bitwise_equal_entries"] = all(torch.equal(out[1], o[1]) and torch.equal(out[2], o[2])
                                           for o in others)
        rec["digest"] = _digest(out[1], out[2])
        iters = 100 if y.numel() < 5_000_000 else 20
    rec["ok"] = rec["ok"] and rec["bitwise_equal_entries"]
    timed = {label: calls[kernel] for label, kernel in case["timed"]}
    if lib and mode == "bilinear" and case["timed"][0][1] in ("interp_fwd", "interp_bwd"):
        timed.update(library_calls(f, y, x, g))
    rec["ms"] = {label: time_ms(fn, iters if not label.startswith("lib") else max(iters // 4, 10))
                 for label, fn in timed.items()}
    return rec


def worker(root: str, lib: bool) -> None:
    """A turn: every case on the checkout at ``root``; prints their records
    as one JSON line."""
    sys.path.insert(0, root)
    import torch

    from paradis_torch import _build

    _build.build()
    records = []
    for case in cases():
        records.append(run_case(case, lib))
        torch.cuda.empty_cache()
    print(json.dumps(records), flush=True)


def turn(root: Path, lib: bool) -> list:
    """One turn in a process of its own."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", str(root)]
    res = subprocess.run(cmd + (["--lib"] if lib else []), capture_output=True, text=True,
                         timeout=900)
    if res.returncode:
        raise SystemExit(f"bench_bilinear: the turn on {root} failed:\n{res.stdout[-4000:]}\n"
                         f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another checkout whose kernels to time (repeatable)")
    ap.add_argument("--history", action="append", default=[],
                    help="a checkout whose kernels to time, its bits not required (repeatable)")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--out", default=None, help="write every record here as one JSON list")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--lib", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_bilinear: no CUDA device; it times kernels on a card")
    if args.worker:
        worker(args.worker, args.lib)
        return []
    t0 = time.perf_counter()
    others = args.other + args.history
    sides = {"new": ROOT} | {Path(d).resolve().name: Path(d).resolve() for d in others}
    if len(sides) != 1 + len(others):
        raise SystemExit(f"bench_bilinear: the checkouts need names of their own: {others}")
    checked = {Path(d).resolve().name for d in args.other}
    runs = {side: [] for side in sides}
    for r in range(args.rounds):
        for side in (list(sides) if r % 2 == 0 else list(sides)[::-1]):
            runs[side].append(turn(sides[side], lib=side == "new"))
    records = []
    for i, case in enumerate(cases()):
        new = [run[i] for run in runs["new"]]
        rec = {k: v for k, v in new[0].items() if k not in ("ms", "digest")}
        rec.update(case=case["id"], ok=all(n["ok"] for n in new),
                   bitwise_equal_rounds=len({n["digest"] for n in new}) == 1)
        rec["bound_ms"], rec["bound_by"] = bound(case)
        for side in sides:
            for label in runs[side][0][i]["ms"]:
                times = [run[i]["ms"][label] for run in runs[side]]
                key = label if side == "new" else f"{side}_{label}"
                rec[key], rec[f"{key}_rounds"] = sum(times) / len(times), times
        for side in list(sides)[1:]:
            other = [run[i] for run in runs[side]]
            rec[f"{side}_bitwise_equal"] = ({n["digest"] for n in new}
                                            == {o["digest"] for o in other})
            rec[f"{side}_ok"] = all(o["ok"] for o in other)
            if side in checked:
                rec["ok"] = rec["ok"] and rec[f"{side}_bitwise_equal"] and rec[f"{side}_ok"]
        rec["ok"] = rec["ok"] and rec["bitwise_equal_rounds"]
        records.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {"card": card_line(), "ok": all(r["ok"] for r in records),
               "seconds": time.perf_counter() - t0, "rounds": args.rounds, "other": args.other,
               "history": args.history,
               "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(records + [summary], indent=1))
    if not summary["ok"]:
        raise SystemExit("bench_bilinear: a check failed")
    return records


if __name__ == "__main__":
    main()
