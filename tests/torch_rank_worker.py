"""One rank of a data-parallel or spatial train-step run, for the
multi-rank tests.

    python tests/torch_rank_worker.py IN.npz OUT.npz '{"overrides": [...], ...}'

Started once per rank with the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; see
``launch``), or alone without it for the one-process run.  ``IN.npz``
holds the model's parameters (``param:<name>``) and the global batches
(``batch<k>:<key>``, ``k`` from 0); the settings are the port's config
overrides (``compute.lat_devices`` / ``compute.spatial_devices`` among
them for a spatial run), ``device``, ``grid`` and ``fsdp``.  Each rank
builds the model of the overrides on the grid (equiangular, without the
poles), loads the parameters, takes one train step a batch on its rows of
it (``distributed.local_batch_slice`` by its data index) and, over spatial
axes, its block of them (``RankGrid.block``), and rank 0 writes the losses,
gradient norms, final parameters and every rank's launches of the
interpolation kernels #1 and #2 to ``OUT.npz``.  No JAX: the ``gpu`` tests
use it too.

    python tests/torch_rank_worker.py ops OUT '{"lat": L, "space": S, "grid": [H, W]}'

holds the spatial layers against their one-process selves on each rank of
an ``L × S`` launch (``ops_main``), and with ``"models": [...]`` the whole
model on grids that its blocks or its coarse grid do not fit.

With ``"fsdp": true`` a step run also holds the sharded layout: after each
step every rank's digest of the parameters it owns, which the ranks of a
data group's spatial positions must share bitwise, the gradient norm that
the replicated layout computes from the same averaged gradients, and with
``"resume": K`` a sharded checkpoint after step ``K`` (under ``OUT``'s
name, ``.ckpt``) from which a fresh model and optimizer, restored in the
same processes, take the steps after ``K`` again.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    """A free port for a launch's store, drawn at random below the ephemeral
    range.  A port that ``bind(0)`` hands out and this function frees could
    be taken, before the launch's rank 0 binds it seconds later, by one of
    the sockets that other ranks' gloo binds to port 0; a launch whose
    store then fails to bind hangs its other ranks."""
    import random

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.SystemRandom()
    while True:
        port = rng.randrange(10000, max(low, 10001))
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


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
        """Every process's return code and output; one still running at the
        deadline is killed, and returns -9 with what it wrote till then."""
        outs = []
        try:
            for p in procs:
                left = max(1.0, timeout - (time.monotonic() - t0))
                try:
                    out, _ = p.communicate(timeout=left)
                except subprocess.TimeoutExpired:
                    os.killpg(p.pid, 9)
                    out, _ = p.communicate()
                    out += f"\n[killed after {timeout} s]"
                outs.append((p.returncode, out))
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, 9)
                    p.wait()
        return outs

    return wait


def main(argv: list[str]) -> None:
    import hashlib

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
    from paradis_torch.train import checkpoint as ckpt
    from paradis_torch.train.optim import grad_norm
    from paradis_torch.train.step import create_train_state

    src, dst, settings = Path(argv[0]), Path(argv[1]), json.loads(argv[2])
    cfg = load_config(overrides=settings["overrides"])
    ranks = distributed.initialize_distributed(cfg, settings.get("device", "cpu"))
    fsdp, resume = settings.get("fsdp", False), settings.get("resume")
    try:
        device = ranks.device
        nlat, nlon = settings["grid"]
        lat, lon = equiangular_lat_lon(nlat, nlon, include_poles=False)
        d = dims(cfg)
        data = np.load(src)
        grid = distributed.rank_grid(cfg)
        loss_fn = WeightedLoss.from_config(cfg, lat, dyn_output_features(cfg.features),
                                           nlon=nlon, device=device)
        gathered = distributed.is_initialized()

        def everyone(obj) -> list:
            objs = [None] * ranks.world
            if gathered:
                torch.distributed.all_gather_object(objs, obj)
            return objs if gathered else [obj]

        def build(zero: bool = False):
            """A model with the input's weights (or zeros, for a restore),
            its layout over the ranks, optimizer and step."""
            model = Paradis.from_config(cfg, input_dim=d["input_dim"],
                                        output_dim=d["output_dim"], lat_deg=lat, lon_deg=lon,
                                        device=device)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(torch.zeros(p.shape) if zero
                            else torch.from_numpy(data[f"param:{name}"]))
            parallel = (distributed.DataParallel(model, fsdp=fsdp, grid=grid)
                        if gathered else None)
            opt = build_optimizer(cfg, model, parallel)
            if fsdp:
                # the gradient norm the replicated layout takes of the same
                # averaged gradients, read before the owners keep their own
                average = parallel.average_gradients

                def averaged(owned_only: bool = True):
                    average(owned_only=False)
                    replicated.append(float(grad_norm([p for _, p in parallel.named])))
                    if owned_only:
                        for n, p in parallel.named:
                            if not parallel.owns(n):
                                p.grad = None

                parallel.average_gradients = averaged
            step = make_train_step(model, loss_fn, cfg, opt, parallel=parallel)
            return model, parallel, step, create_train_state(model, opt, parallel)

        def batch_of(k: int) -> dict:
            batch = {key: torch.from_numpy(data[f"batch{k}:{key}"])
                     for key in ("input", "target", "forcings", "constants")}
            rows = distributed.local_batch_slice(batch["input"].shape[0], grid.d, grid.data)
            batch = {key: v[rows] for key, v in batch.items()}
            if grid.spatial > 1:
                batch = {key: grid.block(v).contiguous() for key, v in batch.items()}
            return {key: v.to(device) for key, v in batch.items()}

        def whole_params(model, parallel) -> dict:
            with parallel.gathered() if parallel is not None else contextlib.nullcontext():
                return {n: p.detach().float().cpu().numpy().copy()
                        for n, p in model.named_parameters()}

        def peers_equal(model, parallel) -> bool:
            """Whether the ranks of each data group's spatial positions hold
            bitwise the same parameters of their own."""
            h = hashlib.sha256()
            for n, p in sorted(model.named_parameters()):
                if parallel is None or parallel.owns(n):
                    h.update(p.detach().cpu().numpy().tobytes())
            by_d = {}
            for dd, digest in everyone((grid.d, h.hexdigest())):
                by_d.setdefault(dd, set()).add(digest)
            return all(len(v) == 1 for v in by_d.values())

        writers = []  # the files this rank wrote through the checkpoint module
        write_file = ckpt.write_file

        def recording_write(path, obj):
            writers.append(Path(path).name)
            write_file(path, obj)

        ckpt.write_file = recording_write
        replicated = []
        model, parallel, step, state = build()
        manager = (ckpt.CheckpointManager(str(dst.with_name(dst.name + ".ckpt")),
                                          step_every=resume) if resume else None)
        out = {"loss": [], "grad_norm": [], "loss_per_step": [], "peers_equal": []}
        saved = None
        before = launch_counts()
        k = 0
        while f"batch{k}:input" in data.files:
            m = step(state, batch_of(k), d["n_common"])
            for key in ("loss", "grad_norm", "loss_per_step"):
                out[key].append(m[key].detach().float().cpu().numpy())
            out["peers_equal"].append(peers_equal(model, parallel))
            k += 1
            if manager is not None and state.step == resume:
                manager.maybe_save_step(state.step, state)
                saved = whole_params(model, parallel)
        if parallel is not None:
            parallel.gather()
        after = launch_counts()
        out["grad_norm_replicated"] = list(replicated)
        arrays = {f"param:{n}": p.detach().float().cpu().numpy()
                  for n, p in model.named_parameters()}
        if saved is not None:
            arrays.update({f"ckpt_param:{n}": v for n, v in saved.items()})
            # the same processes restore a fresh model from the checkpoint and go on
            model, parallel, step, state = build(zero=True)
            manager.restore(state, manager.latest_path())
            resumed = {"resumed_loss": [], "resumed_grad_norm": []}
            for k in range(resume, k):
                m = step(state, batch_of(k), d["n_common"])
                resumed["resumed_loss"].append(float(m["loss"]))
                resumed["resumed_grad_norm"].append(float(m["grad_norm"]))
            out.update(resumed)
            arrays.update({f"resumed_param:{n}": v
                           for n, v in whole_params(model, parallel).items()})
        # every rank's launches of #1 and #2 and its checkpoint files, to rank 0
        counts = everyone([after[n] - before[n] for n in ("interp_fwd", "interp_bwd")])
        files = everyone(writers)
        if ranks.rank == 0:
            arrays.update({key: np.asarray(v) for key, v in out.items()})
            arrays["launches"] = np.asarray(counts)
            arrays["writers"] = np.asarray([r for r, names in enumerate(files)
                                            if any(n.startswith("shard_p") for n in names)],
                                           dtype=np.int64)
            np.savez(dst, **arrays)
    finally:
        distributed.shutdown_distributed()


def ops_main(argv: list[str]) -> None:
    """``ops OUT '{"lat": L, "space": S, "grid": [H, W]}'``: each rank of an
    ``L × S`` launch holds the spatial layers against their one-process
    selves on the same seeded whole fields (made alike on every rank, each
    rank taking its block) and writes what it found to ``OUT.rank<r>.json``:

    * ``pad``: for pads 1, 2, 3, the sharded ``geocyclic_pad`` bitwise the
      block of the whole field's pad, and its backward bitwise the adjoint of
      cutting that block out of the whole pad (fields and cotangents of small
      integers, so every sum of the adjoint is exact whatever its order);
    * ``pole``, ``advection``, ``loss``: ``enforce_pole_continuity``, a
      bicubic ``NeuralSemiLagrangian`` (plain path) and the latitude-weighted
      reversed Huber loss, each output and gradient's largest gap to the one
      process, as a share of the largest magnitude (parameter gradients
      summed over the ranks);
    * ``ns``: this grid's split Newton–Schulz stack against the redundant
      one (largest gap);
    * ``models``: for each of ``"models"``' cases (``{"overrides": [...],
      "grid": [H, W]}``, the overrides naming the case's own ``lat`` /
      ``space`` on this launch's ranks and its ``model.coarsening_factor``),
      the whole model's largest gap as above (the output, the input's
      gradient, every parameter's gradient summed over the spatial group)
      and the ``[lat, space]`` of the grid its physics layers ran on.
    """
    import numpy as np
    import torch

    from paradis_torch import distributed
    from paradis_torch.config import load_config
    from paradis_torch.ops.advection import NeuralSemiLagrangian, enforce_pole_continuity
    from paradis_torch.sphere.geometry import equiangular_lat_lon, latitude_weights, lonlat_grids
    from paradis_torch.sphere.padding import geocyclic_pad, geocyclic_pad_whole
    from paradis_torch.sphere.partition import spatial_rules
    from paradis_torch.train.loss import WeightedLoss
    from paradis_torch.train.optim import newton_schulz_batched

    out, settings = Path(argv[0]), json.loads(argv[1])
    lat, space = settings["lat"], settings["space"]
    H, W = settings["grid"]
    cfg = load_config(overrides=[f"compute.lat_devices={lat}",
                                 f"compute.spatial_devices={space}"])
    distributed.initialize_distributed(cfg, "cpu")
    try:
        grid = distributed.rank_grid(cfg)
        rows, cols = grid.rows(H), grid.cols(W)
        gen = torch.Generator().manual_seed(5)
        res = {"rank": grid.spatial_index}

        def rel(a, b):
            a, b = a.detach(), b.detach()
            return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

        def run(fn, *whole, params=(), on=None):
            """fn's output and gradients on the whole fields, and on this
            rank's blocks of grid ``on`` (this launch's unless given) inside
            spatial_rules: the gaps."""
            on = grid if on is None else on
            ins = [x.clone().requires_grad_(True) for x in whole]
            ref = fn(*ins)
            ct = torch.randn(ref.shape, generator=gen) if ref.dim() else torch.tensor(1.0)
            ref_grads = torch.autograd.grad((ref * ct).sum(), ins + list(params))
            blk = [on.block(x).clone().requires_grad_(True) for x in whole]
            with spatial_rules(on):
                got = fn(*blk)
            ct_blk = on.block(ct) if ref.dim() else ct
            grads = torch.autograd.grad((got * ct_blk).sum(), blk + list(params))
            ref_out = on.block(ref) if ref.dim() else ref
            gaps = [rel(got, ref_out)]
            gaps += [rel(g, on.block(r)) for g, r in zip(grads[:len(blk)], ref_grads)]
            for g, r in zip(grads[len(blk):], ref_grads[len(blk):]):
                torch.distributed.all_reduce(g, group=on.spatial_group)
                gaps.append(rel(g, r))
            return max(gaps)

        # the pad, bitwise (small integers: every sum exact)
        pads = {}
        for pad in (1, 2, 3):
            x = torch.randint(-8, 9, (2, H, W, 3), generator=gen).float()
            ct = torch.randint(-8, 9, (2, H + 2 * pad, W + 2 * pad, 3), generator=gen).float()
            h, w = rows.stop - rows.start, cols.stop - cols.start
            window = (slice(None), slice(rows.start, rows.start + h + 2 * pad),
                      slice(cols.start, cols.start + w + 2 * pad))
            xw = x.clone().requires_grad_(True)
            cover = torch.zeros_like(ct)  # the whole pad's cotangent from every block's window
            for l_ in range(lat):
                for s_ in range(space):
                    cover[:, l_ * h:l_ * h + h + 2 * pad, s_ * w:s_ * w + w + 2 * pad] += 1
            want = geocyclic_pad_whole(xw, pad)
            (want * ct * cover).sum().backward()
            xb = grid.block(x).clone().requires_grad_(True)
            with spatial_rules(grid):
                got = geocyclic_pad(xb, pad)
            (got * ct[window]).sum().backward()
            pads[pad] = [bool(torch.equal(got, want.detach()[window])),
                         bool(torch.equal(xb.grad, grid.block(xw.grad)))]
        res["pad"] = pads

        lat_deg, lon_deg = equiangular_lat_lon(H, W, include_poles=False)
        lat_g, lon_g = (torch.tensor(a, dtype=torch.float32) for a in
                        lonlat_grids(np.deg2rad(lat_deg), np.deg2rad(lon_deg)))
        res["pole"] = run(enforce_pole_continuity, torch.randn(2, H, W, 4, generator=gen))

        adv = NeuralSemiLagrangian(8, 4, (H, W), interpolation="bicubic", generator=gen)
        adv.impl = "plain"
        res["advection"] = run(
            lambda hid, u, v: adv(hid, u, v, 0.5, lat_g, lon_g),
            torch.randn(2, H, W, 8, generator=gen), 0.3 * torch.randn(2, H, W, 4, generator=gen),
            0.3 * torch.randn(2, H, W, 4, generator=gen), params=list(adv.parameters()))

        loss = WeightedLoss(kind="reversed_huber",
                            feature_weights=torch.rand(5, generator=gen) + 0.5,
                            lat_weights=torch.tensor(latitude_weights(lat_deg),
                                                     dtype=torch.float32))
        res["loss"] = run(loss, torch.randn(2, H, W, 5, generator=gen),
                          torch.randn(2, H, W, 5, generator=gen))

        # distributed NorMuon: a stack of 12 divides every axis here
        from paradis_torch.train.optim import ParadisOptimizer, _MuonGroup

        stack = torch.randn(12, 16, 24, generator=gen)
        opt = ParadisOptimizer.__new__(ParadisOptimizer)
        opt.ns_steps, opt.ns_dtype, opt.grid = 5, torch.float32, grid
        group = _MuonGroup.__new__(_MuonGroup)
        group.share = grid.ns_share(12)
        split = opt._orthogonalize(group, stack, "left")
        whole = newton_schulz_batched(stack, 5, side="left", dtype=torch.float32)
        res["ns"] = float((split - whole).abs().max())
        res["ns_ways"] = group.share[0]

        # the whole model on grids its blocks or its coarse grid do not fit
        res["models"] = []
        for case in settings.get("models", []):
            from paradis_torch.model import Paradis
            from paradis_torch.tools.bench_artifact import dims

            mcfg = load_config(overrides=case["overrides"])
            on = distributed.rank_grid(mcfg)
            mh, mw = case["grid"]
            m_lat, m_lon = equiangular_lat_lon(mh, mw, include_poles=False)
            dd = dims(mcfg)
            model = Paradis.from_config(mcfg, input_dim=dd["input_dim"],
                                        output_dim=dd["output_dim"], lat_deg=m_lat,
                                        lon_deg=m_lon, device="cpu")
            proc = on.fit(*model.mesh_size_coarse)
            res["models"].append({
                "gap": run(model, 2.0 * torch.randn(2, mh, mw, dd["input_dim"], generator=gen),
                           params=list(model.parameters()), on=on),
                "processor": [proc.lat, proc.space]})
        out.with_name(f"{out.name}.rank{grid.spatial_index}.json").write_text(json.dumps(res))
    finally:
        distributed.shutdown_distributed()


if __name__ == "__main__":
    if sys.argv[1] == "ops":
        ops_main(sys.argv[2:])
    else:
        main(sys.argv[1:])
