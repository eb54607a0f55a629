"""Multi-rank runs of the port's entry points on the CPU, as a user launches
them: ``python -m torch.distributed.run --nproc-per-node 2 -m
paradis_torch.cli.train`` (and ``cli.forecast``) with ``--device cpu``, two
ranks over gloo on ``127.0.0.1``, each launch in its own session killed
after ``TIMEOUT`` seconds (``tests/torch_rank_worker.py:launch``).

On the toy store with two training samples (one global batch of 2 an epoch,
so a resumed run's fresh epoch order changes nothing), float32 compute,
NorMuon with float32 Newton–Schulz, 4 steps, validation and a step
checkpoint every 2, the gradient and parameter statistics logged
(``training.log_additional_stats``):

* the 2-rank replicated run against one process with
  ``compute.batch_size=2``: the same metric names at the same steps, each
  within ``RTOL`` (the train step's limit: float32 sums in another order),
  only rank 0's files;
* 2-rank FSDP against 2-rank replicated: losses and validation losses
  equal, gradient norms and the statistics within ``FSDP_RTOL`` (measured
  1e-7: the sharded norms sum each rank's squares, then add the ranks'), the final
  parameters equal (each parameter's update is computed whole by its owner,
  on the same averaged gradient);
* the FSDP run resumed from its sharded step-2 checkpoint: steps 3-4 and the
  final parameters bitwise the uninterrupted run's; the same checkpoint
  restored into one process (``batch_size=2``): its parameters and
  optimizer state bitwise the shards', and 2 more steps within ``RTOL``;
* a sharded checkpoint taken inside an accumulation window (the ranks'
  window gradients averaged and saved with the shards) resumes bitwise;
* ``cli.forecast --num-devices 2`` over 3 init times (a ragged share)
  against one process: every array of the two stores equal.
"""

import pytest

torch = pytest.importorskip("torch")

import csv  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from paradis_torch.data import zarrlite  # noqa: E402
from paradis_torch.train.checkpoint import save_params  # noqa: E402
from paradis_torch.train.loop import Trainer  # noqa: E402
from paradis_torch.train.sharded_ckpt import read_sharded  # noqa: E402
from torch_parity import build_torch_toy_store, torch_toy_config  # noqa: E402
from torch_rank_worker import free_port, launch  # noqa: E402

RTOL = 1e-5
FSDP_RTOL = 1e-6
TIMEOUT = 180
CLOCKS = {"dt", "samples_per_sec", "host_rss_mb", "jit_cache_entries"}
RUN = {"training.dataset.end_date": "2000-01-01T06:00:00", "training.max_steps": 4,
       "training.optimizer.ns_dtype": "float32", "training.progress_bar": False,
       "training.log_additional_stats": True,
       "training.validation_dataset.validation_every_n_steps": 2,
       "training.validation_dataset.validation_batches": 1,
       "training.checkpointing.step_every": 2}
# torch_toy_config's overrides, for the command line
TOY = ["features.pressure_levels=[500,850,1000]", "model.latent_size=16",
       "model.velocity_vectors=4", "model.num_layers=2", "model.bias_channels=2",
       "model.bias_rank=4", "model.physblock.velocity_net.hidden_dim=8",
       "model.physblock.reaction.hidden_dim=8", "model.physblock.output_proj.hidden_dim=8",
       "training.dataset.start_date=2000-01-01", "training.validation_dataset.start_date=2000-01-06",
       "training.validation_dataset.end_date=2000-01-07", "training.log_every_n_steps=1",
       "training.scheduler.wsd.warmup=1", "training.scheduler.wsd.decay=1",
       "compute.use_amp=false"]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return build_torch_toy_store(tmp_path_factory.mktemp("multirank"))


def _launcher(n: int, module: str) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
            "--master-addr", "127.0.0.1", "--master-port", str(free_port()), "-m", module]


def _train_args(store, log_dir, **more) -> list[str]:
    over = dict(RUN, **{"dataset.root_dir": str(store), "training.log_dir": str(log_dir)}, **more)
    return ["--device", "cpu", *TOY, *(f"{k}={v}" for k, v in over.items())]


def _rows(log_dir: Path) -> dict:
    """``{(step, name): [values in the order logged]}`` (the end-of-epoch
    validation may log a step's validation twice, in one process too)."""
    out = {}
    with open(log_dir / "metrics.csv") as f:
        for r in list(csv.reader(f))[1:]:
            out.setdefault((int(r[0]), r[1]), []).append(float(r[2]))
    return out


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def _check(outs):
    assert all(rc == 0 for rc, _ in outs), [out[-3000:] for _, out in outs]


@pytest.fixture(scope="module")
def runs(store, tmp_path_factory):
    """The replicated, FSDP and one-process runs, launched together."""
    base = tmp_path_factory.mktemp("runs")
    waits = {
        "dp": launch(_launcher(2, "paradis_torch.cli.train")
                     + _train_args(store, base / "dp", **{"compute.num_devices": 2}), 0, TIMEOUT),
        "fsdp": launch(_launcher(2, "paradis_torch.cli.train")
                       + _train_args(store, base / "fsdp", **{"compute.fsdp": "true"}), 0,
                       TIMEOUT),
        "one": launch([sys.executable, "-m", "paradis_torch.cli.train"]
                      + _train_args(store, base / "one", **{"compute.batch_size": 2}), 0,
                      TIMEOUT),
    }
    for wait in waits.values():
        _check(wait())
    return {k: base / k for k in waits}


def test_two_ranks_train_as_one_process_with_the_global_batch(runs):
    dp, one = _rows(runs["dp"]), _rows(runs["one"])
    # as many rows as one process logs: only rank 0 wrote them
    assert {k: len(v) for k, v in dp.items()} == {k: len(v) for k, v in one.items()}
    assert {n for _, n in dp} >= {"train_loss", "grad_norm", "val_loss", "lr"}
    for key, v in one.items():
        if key[1] in CLOCKS:
            continue
        np.testing.assert_allclose(dp[key], v, rtol=RTOL, err_msg=str(key))
    # the logged throughput counts the global batch
    assert dp[(4, "samples_per_sec")][0] == pytest.approx(2 / dp[(4, "dt")][0])
    # and the same files as the one-process run's
    assert _files(runs["dp"]) == _files(runs["one"])
    assert not [f for f in _files(runs["dp"]) if "shard" in f]


def test_fsdp_trains_as_the_replicated_ranks(runs):
    dp, fsdp = _rows(runs["dp"]), _rows(runs["fsdp"])
    assert {k: len(v) for k, v in dp.items()} == {k: len(v) for k, v in fsdp.items()}
    for key, v in dp.items():
        if key[1] in ("train_loss", "val_loss", "lr", "geopotential_h500"):
            assert fsdp[key] == v, key
        elif key[1] == "grad_norm" or key[1].split("/")[0] in ("grad", "pnorm", "gradratio"):
            # norms summed a rank's shard at a time, then over the ranks
            np.testing.assert_allclose(fsdp[key], v, rtol=FSDP_RTOL, err_msg=str(key))
    assert (1, "grad/total") in dp
    ckpt = runs["fsdp"] / "checkpoints"
    for tag in ("steps/00000002", "steps/00000004", "epochs/0004", "best/best"):
        assert sorted((ckpt / tag / "state_sharded").iterdir()) == [
            ckpt / tag / "state_sharded" / f"shard_p{r}.pt" for r in (0, 1)]
    sharded = read_sharded(ckpt / "epochs" / "0004" / "state_sharded")
    whole = torch.load(runs["dp"] / "checkpoints" / "epochs" / "0004" / "state.pt",
                       weights_only=True)
    assert sharded["step"] == whole["step"] == 4
    for name, p in whole["params"].items():
        assert torch.equal(sharded["params"][name], p), name


def test_a_sharded_checkpoint_resumes_bitwise_and_restores_into_one_process(
        store, runs, tmp_path):
    step2 = runs["fsdp"] / "checkpoints" / "steps" / "00000002"
    resume = launch(_launcher(2, "paradis_torch.cli.train") + _train_args(
        store, tmp_path / "resumed", **{"compute.fsdp": "true", "init.restart": "true",
                                        "init.checkpoint_path": str(step2)}), 0, TIMEOUT)
    # the same checkpoint into one process, meanwhile
    cfg = torch_toy_config(store, **dict(RUN, **{"compute.batch_size": 2, "init.restart": True,
                                                 "init.checkpoint_path": str(step2)}))
    t = Trainer(cfg, log_dir=str(tmp_path / "one"), device="cpu")
    saved = read_sharded(step2 / "state_sharded")
    assert t.state.step == 2 and t.parallel is None
    for name, p in t.model.named_parameters():
        assert torch.equal(p, saved["params"][name]), name
    got = t.optimizer.param_states()["params"]
    assert sorted(got) == sorted(saved["optimizer"]["params"])
    for name, entry in saved["optimizer"]["params"].items():
        for key, v in entry.items():
            assert (v is None and got[name][key] is None) or torch.equal(got[name][key], v)
    t.fit()
    _check(resume())

    full, resumed, one = _rows(runs["fsdp"]), _rows(tmp_path / "resumed"), _rows(tmp_path / "one")
    keys = [(s, n) for s in (3, 4) for n in ("train_loss", "lr", "grad_norm")]
    assert {k: resumed[k] for k in keys} == {k: full[k] for k in keys}
    for k in keys:
        np.testing.assert_allclose(one[k], full[k], rtol=RTOL, err_msg=str(k))
    a = read_sharded(runs["fsdp"] / "checkpoints" / "steps" / "00000004" / "state_sharded")
    b = read_sharded(tmp_path / "resumed" / "checkpoints" / "steps" / "00000004"
                     / "state_sharded")
    for name, p in a["params"].items():
        assert torch.equal(b["params"][name], p), name


def test_a_sharded_checkpoint_inside_an_accumulation_window_resumes_bitwise(store, tmp_path):
    """``accumulate_grad_batches=2`` on the one global batch an epoch: the
    first epoch's checkpoint falls inside the window, so the ranks' window
    gradients are averaged in place and saved with the shards; a resume from
    it takes the same two steps as the uninterrupted run, bitwise."""
    acc = {"compute.fsdp": "true", "training.accumulate_grad_batches": 2,
           "training.max_steps": 2}
    full = tmp_path / "full"
    _check(launch(_launcher(2, "paradis_torch.cli.train")
                  + _train_args(store, full, **acc), 0, TIMEOUT)())
    epoch1 = full / "checkpoints" / "epochs" / "0001"
    saved = read_sharded(epoch1 / "state_sharded")
    assert (saved["step"], saved["micro_step"]) == (0, 1) and saved["accum"]
    _check(launch(_launcher(2, "paradis_torch.cli.train") + _train_args(
        store, tmp_path / "resumed", **acc, **{"init.restart": "true",
                                               "init.checkpoint_path": str(epoch1)}),
        0, TIMEOUT)())
    a, b = _rows(full), _rows(tmp_path / "resumed")
    for key in [(s, n) for s in (1, 2) for n in ("train_loss", "grad_norm", "lr")]:
        assert b[key][-1] == a[key][-1], key
    last = sorted((full / "checkpoints" / "epochs").iterdir())[-1].name
    x = read_sharded(full / "checkpoints" / "epochs" / last / "state_sharded")
    y = read_sharded(sorted((tmp_path / "resumed" / "checkpoints" / "epochs").iterdir())[-1]
                     / "state_sharded")
    assert x["step"] == y["step"] == 2
    for name, p in x["params"].items():
        assert torch.equal(y["params"][name], p), name


def test_two_rank_forecast_writes_the_one_process_store(store, tmp_path):
    cfg = torch_toy_config(store)
    from paradis_torch.tools.bench_artifact import dims
    from paradis_torch.model import Paradis
    from paradis_torch.sphere.geometry import equiangular_lat_lon

    d = dims(cfg)
    lat, lon = equiangular_lat_lon(8, 16, include_poles=False)
    model = Paradis.from_config(cfg, input_dim=d["input_dim"], output_dim=d["output_dim"],
                                lat_deg=lat, lon_deg=lon, device="cpu")
    save_params(tmp_path / "params.pt", model)
    args = ["--checkpoint-path", str(tmp_path / "params.pt"), "--root-dir", str(store),
            "--forecast-steps", "4", "--sampling-interval", "12h", "--start-date",
            "2000-01-06", "--end-date", "2000-01-07", "--write-every-n", "2", "--device",
            "cpu", *[a for a in TOY if not a.startswith("training.")]]
    two = launch(_launcher(2, "paradis_torch.cli.forecast") + args
                 + ["--num-devices", "2", "--output-file", str(tmp_path / "two.zarr")], 0,
                 TIMEOUT)
    one = launch([sys.executable, "-m", "paradis_torch.cli.forecast"] + args
                 + ["--output-file", str(tmp_path / "one.zarr")], 0, TIMEOUT)
    outs = two() + one()
    _check(outs)
    assert sum("forecast written" in out for _, out in outs) == 2  # rank 0's, and one's
    a, b = zarrlite.open_store(tmp_path / "one.zarr"), zarrlite.open_store(tmp_path / "two.zarr")
    assert sorted(a.arrays()) == sorted(b.arrays())
    assert a["time"].shape == (3,)  # 3 inits over 2 ranks
    for name in a.arrays():
        x, y = a[name][...], b[name][...]
        assert x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
