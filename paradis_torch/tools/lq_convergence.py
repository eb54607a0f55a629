"""Codec convergence A/B: lossless Blosc-LZ4 against lossy lq16 training stores.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.lq_convergence [--steps 300] [--codec-b lq16] [--device cpu]

The port's counterpart of ``scripts/lq_convergence.py``: the reference's
preprocessed archives are lossy-quantized by default; the training stores
default to lossless Blosc-LZ4.  The same tiny model as ``ns_convergence``
(AdamW, lr 1e-3) trains from the same seed on the same synthetic 8 × 16 data
preprocessed both ways, and the loss trajectories are compared step by step:
if the 16-bit per-layer quantization does not move the trajectory, lq16 is
safe for large archives.  On the card unless given ``--device cpu``; without
a card and without ``--device cpu`` it raises.  Prints one JSON line with
the JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

from paradis_torch.tools.flagship import device_of
from paradis_torch.tools.ns_convergence import build_store, toy_config, toy_train


def _train(store: Path, steps: int, seed: int = 0, device=None, init=None) -> np.ndarray:
    return toy_train(store, steps, toy_config(name="adamw", lr=1e-3), seed, device, init)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--codec-b", default="lq16")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = device_of(args.device, "lq_convergence")

    with tempfile.TemporaryDirectory(prefix="lq_ab_") as tmp:
        stores = build_store(Path(tmp), codecs=("lz4", args.codec_b))
        la = _train(stores["lz4"], args.steps, device=device)
        lb = _train(stores[args.codec_b], args.steps, device=device)

    d = np.abs(la - lb)
    rel = d / np.maximum(np.abs(la), 1e-9)
    tail = slice(args.steps // 2, None)
    res = {
        "codec_a": "lz4", "codec_b": args.codec_b, "steps": args.steps,
        "final_loss_a": float(la[-1]),
        "final_loss_b": float(lb[-1]),
        "max_abs_diff": float(d.max()),
        "max_rel_diff": float(rel.max()),
        "tail_mean_a": float(la[tail].mean()),
        "tail_mean_b": float(lb[tail].mean()),
        "losses_a": la.tolist(), "losses_b": lb.tolist(), "device": str(device),
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
