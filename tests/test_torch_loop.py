"""The port's host training loop (``train/loop.py``) and its CLI, on the CPU.

Counterparts of ``tests/test_loop_controls.py`` (early stopping, validation
cadence, NaN watchdog) and ``tests/test_sync_cadence.py`` on the port's
``Trainer``; one parity run of the JAX ``Trainer`` and the port's on the toy
store (the JAX initial parameters bridged into the port, float32 compute,
NorMuon with float32 Newton–Schulz, 4 steps, validation every 2, deep
statistics on): the same ``metrics.csv`` names at the same steps, ``lr``
bitwise, losses, gradient norms and the report RMSE within ``RTOL``, the
limit ``tests/test_torch_train_step.py`` holds the train step to (float32
sums in another order; the JAX model runs its dense interpolation on the CPU,
the port its plain gather); weights-only ``init.checkpoint_path``; an
``init.restart`` resume bitwise equal to the uninterrupted run; the CLI in a
subprocess with ``--device cpu``.  The parity run is this file's one JAX
``Trainer`` compile (~40 s); the rest runs in a few seconds each.
"""

import pytest

torch = pytest.importorskip("torch")

import csv  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from fixtures import build_toy_store, toy_config  # noqa: E402
from paradis_torch.model import load_flax_params  # noqa: E402
from paradis_torch.train.checkpoint import save_params  # noqa: E402
from paradis_torch.train.loop import NaNLossError, Trainer  # noqa: E402
from paradis_torch.utils.system import platform_device, setup_system  # noqa: E402
from torch_parity import build_torch_toy_store, torch_toy_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
PARITY = {"training.max_steps": 4, "training.optimizer.ns_dtype": "float32",
          "training.log_additional_stats": True,
          "training.validation_dataset.validation_every_n_steps": 2,
          "training.validation_dataset.validation_batches": 1,
          "training.progress_bar": False}
# the port's hosts of metrics that are clocks or memory, not the model's
UNMATCHED = {"dt", "samples_per_sec", "host_rss_mb", "jit_cache_entries"}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return build_torch_toy_store(tmp_path_factory.mktemp("loop"))


def _trainer(store, log_dir, **overrides):
    overrides.setdefault("training.progress_bar", False)
    return Trainer(torch_toy_config(store, **overrides), log_dir=str(log_dir), device="cpu")


def _rows(log_dir: Path) -> list[tuple[int, str, float]]:
    with open(log_dir / "metrics.csv") as f:
        return [(int(r[0]), r[1], float(r[2])) for r in list(csv.reader(f))[1:]]


def _steps_of(rows, name):
    return [s for s, n, _ in rows if n == name]


# -- test_loop_controls.py and test_sync_cadence.py on the port ------------------

def test_early_stop_logic(store, tmp_path):
    t = _trainer(store, tmp_path / "es", **{
        "training.max_steps": 2, "training.optimizer.name": "adamw",
        "training.early_stopping.enabled": True, "training.early_stopping.patience": 2})
    assert t._early_stop_check(1.0) is False   # improving: best updates
    assert t._early_stop_check(0.9) is False
    assert t._early_stop_check(0.95) is False  # stagnating within patience
    assert t._early_stop_check(0.95) is True   # patience exhausted
    t2 = _trainer(store, tmp_path / "es2", **{
        "training.max_steps": 2, "training.optimizer.name": "adamw",
        "training.early_stopping.enabled": True})
    assert t2._early_stop_check(2.0) is True   # divergence threshold 1.5
    assert t2._early_stop_check(float("nan")) is False  # no decision


def test_validation_every_n_steps(store, tmp_path):
    t = _trainer(store, tmp_path, **{
        "training.max_steps": 4, "training.optimizer.name": "adamw",
        "training.validation_dataset.validation_every_n_steps": 2,
        "training.validation_dataset.validation_batches": 1})
    t.fit()
    val_steps = _steps_of(_rows(tmp_path), "val_loss")
    assert 2 in val_steps and 4 in val_steps


def test_nan_watchdog_raises(store, tmp_path):
    t = _trainer(store, tmp_path, **{
        "training.max_steps": 2, "training.optimizer.name": "adamw",
        "training.optimizer.lr": 1e10,  # divergence on purpose
        "training.gradient_clip_val": None})
    with pytest.raises(NaNLossError):
        t.fit()


def test_cadences_survive_large_sync_every(store, tmp_path):
    t = _trainer(store, tmp_path, **{
        "training.max_steps": 6, "training.optimizer.name": "adamw",
        "training.sync_every_n_steps": 7,  # deliberately coprime with cadences
        "training.log_every_n_steps": 5,
        "training.validation_dataset.validation_every_n_steps": 3,
        "training.validation_dataset.validation_batches": 1})
    t.ckpt.step_every = 4  # step-checkpoint cadence not divisible by sync
    assert t.fit()["steps"] == 6
    rows = _rows(tmp_path)
    val_steps = _steps_of(rows, "val_loss")
    assert 3 in val_steps and 6 in val_steps
    assert (tmp_path / "checkpoints" / "steps" / "00000004").exists()
    assert 5 in _steps_of(rows, "train_loss")


# -- the JAX Trainer and the port's ----------------------------------------------

def test_trainer_matches_the_jax_trainer(tmp_path):
    from paradis_tpu.train.loop import Trainer as JaxTrainer

    jstore = build_toy_store(tmp_path / "jax_store")
    jt = JaxTrainer(toy_config(jstore, **PARITY), log_dir=str(tmp_path / "jax"))
    tree = jax.tree.map(np.asarray, jt.state.params)
    jt.fit()

    tstore = build_torch_toy_store(tmp_path / "torch_store")
    tt = Trainer(torch_toy_config(tstore, **PARITY), log_dir=str(tmp_path / "torch"),
                 device="cpu")
    load_flax_params(tt.model, tree)
    assert tt.fit() == {"steps": 4, "epochs": 1, "val_loss": pytest.approx(
        float([v for _, n, v in _rows(tmp_path / "jax") if n == "val_loss"][-1]), rel=RTOL)}

    jrows, trows = _rows(tmp_path / "jax"), _rows(tmp_path / "torch")
    assert [(s, n) for s, n, _ in trows] == [(s, n) for s, n, _ in jrows]
    names = {n for _, n, _ in trows}
    assert {"grad/params", "pnorm/params", "gradratio/params",
            "geopotential_h500"} <= names and "grad_alignment/params" not in names
    assert any(n.startswith("train_loss_channel_weighted/") for n in names)
    for (step, name, tv), (_, _, jv) in zip(trows, jrows):
        if name == "lr":
            assert tv == jv, (step, tv, jv)
        elif name not in UNMATCHED:
            assert tv == pytest.approx(jv, rel=RTOL, abs=1e-7), (step, name, tv, jv)


def test_deep_stats_log_the_adamw_alignment(store, tmp_path):
    """Under AdamW the JAX loop finds Adam's first moment and logs the
    gradient–momentum cosine; the port reads AdamW's ``exp_avg``."""
    t = _trainer(store, tmp_path, **{"training.max_steps": 2,
                                     "training.optimizer.name": "adamw",
                                     "training.log_additional_stats": True})
    t.fit()
    rows = _rows(tmp_path)
    align = [v for _, n, v in rows if n == "grad_alignment/params"]
    assert len(align) == 2 and all(-1.0 <= v <= 1.0 for v in align)
    assert align[0] == pytest.approx(1.0, abs=1e-6)  # first step: m = (1 - β1)·g


# -- checkpoints through the loop ------------------------------------------------

def test_weights_only_checkpoint_path(store, tmp_path):
    a = _trainer(store, tmp_path / "a", **{"training.max_steps": 2})
    a.fit()
    b = _trainer(store, tmp_path / "b", **{
        "training.max_steps": 2,
        "init.checkpoint_path": str(tmp_path / "a" / "checkpoints" / "best" / "best")})
    assert b.state.step == 0
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), name
    # a params file alone loads too
    save_params(tmp_path / "params.pt", a.model)
    c = _trainer(store, tmp_path / "c", **{"init.checkpoint_path": str(tmp_path / "params.pt")})
    assert torch.equal(c.model.input_proj.layer0_CLinear.conv.weight,
                       a.model.input_proj.layer0_CLinear.conv.weight)


def test_restart_resumes_the_uninterrupted_run_bitwise(store, tmp_path):
    """One training sample (every epoch is the same batch, so the loader's
    fresh epoch order after a resume changes nothing): 4 steps straight,
    against a resume from that run's step-2 checkpoint for 2 more."""
    one = {"training.max_steps": 4, "training.dataset.end_date": "2000-01-01T00:00:00",
           "training.checkpointing.step_every": 2,
           "training.validation_dataset.validation_batches": 1}
    full = _trainer(store, tmp_path / "full", **one)
    assert len(full.train_ds) == 1
    full.fit()
    resumed = _trainer(store, tmp_path / "resumed", **one, **{
        "init.restart": True,
        "init.checkpoint_path": str(tmp_path / "full" / "checkpoints" / "steps" / "00000002")})
    assert resumed.state.step == 2
    assert resumed.fit()["steps"] == 4
    for (name, pa), pb in zip(full.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(pa, pb), name
    got = {(s, n): v for s, n, v in _rows(tmp_path / "resumed") if n in ("train_loss", "lr")}
    want = {(s, n): v for s, n, v in _rows(tmp_path / "full") if n in ("train_loss", "lr")}
    assert sorted(got) == [(3, "lr"), (3, "train_loss"), (4, "lr"), (4, "train_loss")]
    assert got == {k: want[k] for k in got}


# -- devices, settings and the CLI ---------------------------------------------------

@pytest.mark.parametrize("override", ["compute.num_devices=2", "compute.spatial_devices=2",
                                      "compute.num_nodes=2",
                                      "compute.coordinator_address=localhost:1234"])
def test_multi_device_settings_raise(store, tmp_path, override):
    """In one process started without the launcher: more devices than were
    launched (a spatial axis of 2 ranks too), or a coordinator without a
    process group, do not fit the run (``ValueError``).  Multi-rank runs:
    ``tests/test_torch_multirank.py``, ``tests/test_torch_spatial_multirank.py``."""
    key, value = override.split("=")
    with pytest.raises(ValueError, match="multi-GPU"):
        _trainer(store, tmp_path, **{key: value})
    assert not (tmp_path / "metrics.csv").exists()


def test_trainer_defaults_to_the_card(store, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(torch_toy_config(store), log_dir=str(tmp_path))


@pytest.mark.parametrize("platform,device", [("auto", "cuda"), ("gpu", "cuda"),
                                             ("cuda", "cuda"), ("cpu", "cpu"), ("tpu", None)])
def test_platform_maps_to_a_device(store, platform, device):
    cfg = torch_toy_config(store, **{"compute.platform": platform})
    if device is None:
        with pytest.raises(ValueError, match="compute.platform"):
            platform_device(cfg)
    else:
        assert platform_device(cfg) == torch.device(device)


def test_setup_system_checks(store, tmp_path):
    torch.backends.cuda.matmul.allow_tf32 = True
    setup_system(torch_toy_config(store, **{"compute.use_amp": True}))
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError, match="max_steps"):
        setup_system(torch_toy_config(store, **{"training.max_steps": 0,
                                                "training.max_epochs": -1}))
    (tmp_path / "exp" / "old").mkdir(parents=True)
    taken = {"training.log_dir": str(tmp_path), "training.experiment_name": "exp"}
    with pytest.raises(FileExistsError):
        setup_system(torch_toy_config(store, **taken))
    setup_system(torch_toy_config(store, **taken, **{"init.restart": True}))


def test_profiler_window_writes_a_trace(store, tmp_path):
    from paradis_torch.utils import tracing

    t = _trainer(store, tmp_path, **{"training.max_steps": 3, "training.profiler.enabled": True,
                                     "training.profiler.start_step": 1,
                                     "training.profiler.num_steps": 1})
    t.fit()
    trace = tmp_path / "profile" / "trace.json"
    assert trace.stat().st_size > 0
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"train_step", "optimizer", "data_wait", "sync"} <= names  # the program's spans
    assert not tracing.is_recording()


def _cli_overrides(store, log_dir):
    cfg = torch_toy_config(store)
    keys = ["model.latent_size", "model.velocity_vectors", "model.num_layers",
            "model.bias_channels", "model.bias_rank", "model.physblock.velocity_net.hidden_dim",
            "model.physblock.reaction.hidden_dim", "model.physblock.output_proj.hidden_dim",
            "training.dataset.start_date", "training.dataset.end_date",
            "training.validation_dataset.start_date", "training.validation_dataset.end_date",
            "training.scheduler.wsd.warmup", "training.scheduler.wsd.decay",
            "compute.use_amp", "dataset.root_dir"]
    return ([f"{k}={cfg.get_path(k)}" for k in keys]
            + ["features.pressure_levels=[500,850,1000]", "training.max_steps=2",
               "training.progress_bar=false", f"training.log_dir={log_dir}",
               "training.experiment_name=cli"])


def test_cli_trains_on_the_cpu_in_a_subprocess(store, tmp_path):
    res = subprocess.run([sys.executable, "-m", "paradis_torch.cli.train", "--device", "cpu",
                          *_cli_overrides(store, tmp_path)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "training done: {'steps': 2" in res.stdout
    assert (tmp_path / "cli" / "metrics.csv").is_file()
    assert (tmp_path / "cli" / "checkpoints" / "last.json").is_file()


def test_cli_defaults_to_the_card(store, tmp_path, monkeypatch):
    from paradis_torch.cli import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(_cli_overrides(store, tmp_path))
    # compute.platform=cpu selects the CPU without --device
    res = train.main(_cli_overrides(store, tmp_path / "p") + ["compute.platform=cpu"])
    assert res["steps"] == 2
