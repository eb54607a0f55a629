"""One rank of a data-parallel train-step run, for the multi-rank tests.

    python tests/torch_rank_worker.py IN.npz OUT.npz '{"overrides": [...], ...}'

Started once per rank with the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; see
``launch``), or alone without it for the one-process run.  ``IN.npz``
holds the model's parameters (``param:<name>``) and the global batches
(``batch<k>:<key>``, ``k`` from 0); the settings are the port's config
overrides, ``device``, ``grid`` and ``fsdp``.  Each rank builds the model
of the overrides on the grid (equiangular, without the poles), loads the
parameters, takes one train step a batch on its rows of it
(``distributed.local_batch_slice``) and rank 0 writes the losses, gradient
norms, final parameters and every rank's launches of the interpolation
kernels #1 and #2 to ``OUT.npz``.  No JAX: the ``gpu`` tests use it
too.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cmd: list[str], world: int, timeout: float, cwd=ROOT, extra_env=None):
    """Start ``cmd`` once per rank with the launcher's environment on
    127.0.0.1 (or once without it when ``world`` is 0); returns a function
    that waits for them all, kills every one of them after ``timeout``
    seconds from the start, and returns ``[(returncode, output)]``."""
    import time

    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env["PYTHONPATH"] = f"{ROOT}:{ROOT / 'tests'}:{env.get('PYTHONPATH', '')}"
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra_env or {})
    procs = []
    for rank in range(max(world, 1)):
        renv = dict(env)
        if world:
            renv.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                        LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port))
        procs.append(subprocess.Popen(cmd, cwd=cwd, env=renv, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      start_new_session=True))
    t0 = time.monotonic()

    def wait() -> list[tuple[int, str]]:
        outs = []
        try:
            for p in procs:
                left = max(1.0, timeout - (time.monotonic() - t0))
                out, _ = p.communicate(timeout=left)
                outs.append((p.returncode, out))
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, 9)
                    p.wait()
        return outs

    return wait


def main(argv: list[str]) -> None:
    import numpy as np
    import torch

    from paradis_torch import distributed
    from paradis_torch.config import load_config
    from paradis_torch.model import Paradis
    from paradis_torch.sphere.geometry import equiangular_lat_lon
    from paradis_torch.data import dyn_output_features
    from paradis_torch.tools.bench_artifact import dims
    from paradis_torch.tools.bench_interp import launch_counts
    from paradis_torch.train import WeightedLoss, build_optimizer, make_train_step
    from paradis_torch.train.step import create_train_state

    src, dst, settings = Path(argv[0]), Path(argv[1]), json.loads(argv[2])
    cfg = load_config(overrides=settings["overrides"])
    ranks = distributed.initialize_distributed(cfg, settings.get("device", "cpu"))
    try:
        device = ranks.device
        nlat, nlon = settings["grid"]
        lat, lon = equiangular_lat_lon(nlat, nlon, include_poles=False)
        d = dims(cfg)
        model = Paradis.from_config(cfg, input_dim=d["input_dim"], output_dim=d["output_dim"],
                                    lat_deg=lat, lon_deg=lon, device=device)
        data = np.load(src)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.from_numpy(data[f"param:{name}"]))
        parallel = (distributed.DataParallel(model, fsdp=settings.get("fsdp", False))
                    if distributed.is_initialized() else None)
        opt = build_optimizer(cfg, model, parallel)
        loss_fn = WeightedLoss.from_config(cfg, lat, dyn_output_features(cfg.features),
                                           nlon=nlon, device=device)
        step = make_train_step(model, loss_fn, cfg, opt, parallel=parallel)
        state = create_train_state(model, opt, parallel)
        out = {"loss": [], "grad_norm": [], "loss_per_step": []}
        before = launch_counts()
        k = 0
        while f"batch{k}:input" in data.files:
            batch = {key: torch.from_numpy(data[f"batch{k}:{key}"])
                     for key in ("input", "target", "forcings", "constants")}
            rows = distributed.local_batch_slice(batch["input"].shape[0], ranks.rank,
                                                 ranks.world)
            batch = {key: v[rows].to(device) for key, v in batch.items()}
            m = step(state, batch, d["n_common"])
            for key in out:
                out[key].append(m[key].detach().float().cpu().numpy())
            k += 1
        if parallel is not None:
            parallel.gather()
        after = launch_counts()
        # every rank's launches of #1 and #2, gathered to rank 0
        mine = torch.tensor([after[n] - before[n] for n in ("interp_fwd", "interp_bwd")])
        counts = [mine]
        if distributed.is_initialized():
            counts = [torch.zeros_like(mine) for _ in range(ranks.world)]
            torch.distributed.all_gather_object(counts, mine)
        if ranks.rank == 0:
            arrays = {key: np.asarray(v) for key, v in out.items()}
            arrays["launches"] = np.stack([c.numpy() for c in counts])
            arrays.update({f"param:{n}": p.detach().float().cpu().numpy()
                           for n, p in model.named_parameters()})
            np.savez(dst, **arrays)
    finally:
        distributed.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1:])
