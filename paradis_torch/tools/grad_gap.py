"""Where the first-step gradient gap between the kernel and plain paths comes from.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 -m paradis_torch.tools.grad_gap [--nlat 128 --nlon 256]

Builds the full-width flagship in float32 from ``configs/default.yaml`` (the
train configuration of ``chip_smoke.py``) on the given grid, once for each
case below, and takes the first train step's parameter gradients three times
on one seeded batch: through the plain interpolation, through the kernels,
and through the kernels again.  Cases: ``compute.interp_band_rad=0.3`` with
and without ``compute.gradient_checkpointing``, and checkpointing without
the band (the unbanded kernels, no clamp).  Prints one JSON line per case:
the largest |kernel − plain| and |kernel − kernel| over the gradient, each
over the largest gradient, and per interpolation call the share of departure
rows the clamp moved and the largest row displacement before the clamp.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nlat", type=int, default=128)
    ap.add_argument("--nlon", type=int, default=256)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("grad_gap: no CUDA device", file=sys.stderr)
        return 2
    from paradis_torch.config import load_config
    from paradis_torch.data import dyn_output_features
    from paradis_torch.model import Paradis
    from paradis_torch.ops import advection
    from paradis_torch.sphere.geometry import equiangular_lat_lon
    from paradis_torch.train import WeightedLoss, build_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    rows = []
    interpolate = advection.interpolate

    def recording(field, pix_y, pix_x, mode, impl="auto", max_dy_pix=None):
        if max_dy_pix is not None:
            H = pix_y.shape[1]
            pad = (field.shape[1] - H) // 2
            arr = torch.arange(H, dtype=torch.float32, device=pix_y.device).view(1, H, 1, 1)
            dev = (pix_y.detach().float() - arr - pad).abs()
            rows.append([float((dev > max_dy_pix).float().mean()), float(dev.max())])
        return interpolate(field, pix_y, pix_x, mode, impl, max_dy_pix)

    advection.interpolate = recording
    nlat, nlon = args.nlat, args.nlon
    lat, lon = equiangular_lat_lon(nlat, nlon, include_poles=False)
    for case, extra in (("band+checkpointing", ["compute.interp_band_rad=0.3",
                                                "compute.gradient_checkpointing=true"]),
                        ("band", ["compute.interp_band_rad=0.3"]),
                        ("checkpointing, no band", ["compute.gradient_checkpointing=true"])):
        cfg = load_config(overrides=["compute.use_amp=false", *extra])
        f = cfg.features
        n_lev = len(f.pressure_levels)
        n_common = len(f.input.atmospheric) * n_lev + len(f.input.surface)
        n_out = len(f.output.atmospheric) * n_lev + len(f.output.surface)
        n_time = int(cfg.dataset.n_time_inputs)
        n_in = (n_common + len(f.input.forcings)) * n_time + len(f.input.constants)
        model = Paradis.from_config(cfg, input_dim=n_in, output_dim=n_out, lat_deg=lat,
                                    lon_deg=lon, device="cuda")
        loss_fn = WeightedLoss.from_config(cfg, lat, dyn_output_features(f), device="cuda")
        optimizer = build_optimizer(cfg, model)
        rng = np.random.default_rng(0)
        x = torch.tensor(rng.normal(size=(1, nlat, nlon, n_in)), dtype=torch.float32,
                         device="cuda")
        target = torch.tensor(rng.normal(size=(1, nlat, nlon, n_out)), dtype=torch.float32,
                              device="cuda")
        grads = {}
        for run in ("plain", "kernel", "kernel again"):
            model.set_interp_impl("plain" if run == "plain" else "auto")
            optimizer.zero_grad()
            rows.clear()
            loss_fn(model(x), target).backward()
            torch.cuda.synchronize()
            grads[run] = torch.cat([p.grad.flatten() for p in optimizer.params])
        scale = float(grads["plain"].abs().max())
        print(json.dumps({
            "case": case, "grid": [nlat, nlon], "card": card, "band_px": model.band_max_dy_pix,
            "kernel_vs_plain": float((grads["kernel"] - grads["plain"]).abs().max()) / scale,
            "kernel_vs_kernel": float((grads["kernel"] - grads["kernel again"]).abs().max())
            / scale,
            "largest_gradient": scale,
            "per_call_clamped_share_and_max_row_displacement_px": rows,
        }), flush=True)
        del model, optimizer, grads
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
